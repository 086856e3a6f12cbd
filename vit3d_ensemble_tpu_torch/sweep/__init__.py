"""The sweep engine: the 18 baseline configs x every fold as stacked models.

The counterpart of `vit3d_ensemble_tpu/sweep/`: configs sharing
(hidden_size, num_heads) differ only in depth and MLP width, which the model
expresses as run-time capacities, so the 18-config grid trains as 3 groups,
each a stacked model of `n_configs x n_folds` cells with a leading model
axis (`stacked.py`) trained by one eager loop (`engine.py`).
"""

from vit3d_ensemble_tpu_torch.sweep.stack import (  # noqa: F401
    ConfigGroup,
    group_configs,
    init_group_params,
    unpad_params,
)
