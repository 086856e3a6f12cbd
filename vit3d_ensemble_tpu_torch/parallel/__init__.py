"""Multi-rank scaling: meshes of torch.distributed ranks and the sharding
rules of the sweeps.

The counterpart of `vit3d_ensemble_tpu/parallel/`.  As in the JAX package
the real parallel axes at this model scale are the model-batch axis (the
18-config grid, the ensemble combinations) and the data axis (folds,
bootstrap replicates), the leading axes of the stacked sweeps; a mesh of
M·N ranks gives each rank one (model, data) block of them, and single-model
data-parallel training sums its gradients over every rank.  TP/PP/SP stay
absent, as in JAX: the largest baseline has 1.2 M parameters and 65 tokens.
"""

from vit3d_ensemble_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    make_dp_train_step,
    make_mesh,
    mesh_from_spec,
    sweep_shardings,
)
