"""Hopper compute kernels (hand-written CUDA) and their plain PyTorch paths."""

from vit3d_ensemble_tpu_torch.ops.attention import (  # noqa: F401
    dot_product_attention,
    set_default_attention_impl,
)
from vit3d_ensemble_tpu_torch.ops.quant import (  # noqa: F401
    int8_dense,
    set_default_quant_impl,
)
