"""Split arrays and batching, the framework-free parts of the JAX package's
`data/`.  The PNG and CSV loaders are not ported yet (ROADMAP.md, queue 1
item 8)."""

from vit3d_ensemble_tpu_torch.data.pipeline import EpochBatcher  # noqa: F401
from vit3d_ensemble_tpu_torch.data.volumes import SplitArrays  # noqa: F401
