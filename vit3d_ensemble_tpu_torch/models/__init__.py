"""PyTorch model families: 3D VisionTransformer baselines (with the optional
ResNetV2 hybrid stem) + stacking ensemble."""

from vit3d_ensemble_tpu_torch.models.vit3d import (  # noqa: F401
    VisionTransformer3D,
    ViTOutput,
)
from vit3d_ensemble_tpu_torch.models.ensemble import TransformerEnsemble  # noqa: F401
from vit3d_ensemble_tpu_torch.models.resnet_hybrid import (  # noqa: F401
    HybridBackbone3D,
    ResNetV2,
)
