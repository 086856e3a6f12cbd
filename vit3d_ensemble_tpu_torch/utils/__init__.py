"""Cross-cutting utilities: seeding, profiling, debug toggles."""

from vit3d_ensemble_tpu_torch.utils.seed import set_seed  # noqa: F401
from vit3d_ensemble_tpu_torch.utils.profiling import (  # noqa: F401
    profile_to,
    step_annotation,
)
from vit3d_ensemble_tpu_torch.utils.debug import enable_nan_checking  # noqa: F401
