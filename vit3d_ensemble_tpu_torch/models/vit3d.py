"""3D Vision Transformer in PyTorch, the counterpart of
`vit3d_ensemble_tpu/models/vit3d.py` (the reference's
`models/modeling.py:55-344`).

Public layout as in the JAX package: channels-last input (B, H, W, Z, C)
and the `ViTOutput(logits, attn_weights, tokens)` triple.  Module and
parameter names are the reference's torch names, the ones
`checkpoint.flax_vit_to_numpy_state` emits (`transformer.encoder.layer.{i}.
attn.query.weight`, ...), so its `state_dict`s load without renaming.

Math contract: pre-LN blocks, LN eps 1e-6, GELU MLP, learned (1, T, D)
position embeddings, CLS token, stride==kernel Conv3D patchify, head =
Linear(D, num_classes) on CLS.  Depth and MLP width are runtime capacities:
`num_layers_active` gates trailing layers to exact identity and
`mlp_active` masks trailing FFN columns to exact zero.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import List, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from vit3d_ensemble_tpu_torch.configs import ViTConfig
from vit3d_ensemble_tpu_torch.models.resnet_hybrid import (
    HybridBackbone3D,
    feature_shape,
)
from vit3d_ensemble_tpu_torch.ops.attention import (
    checkpoint_block,
    dot_product_attention,
    dropout,
    get_default_attention_impl,
)
from vit3d_ensemble_tpu_torch.ops.attention_layer import fused_attention_layer
from vit3d_ensemble_tpu_torch.ops.fused_mlp import fused_mlp
from vit3d_ensemble_tpu_torch.ops.mlp import get_default_mlp_impl
from vit3d_ensemble_tpu_torch.ops.quant import get_default_quant_impl, int8_dense

#: Widths at or below this use one fused (D, 3D) QKV matmul (`vit3d.py:117`).
_FUSED_QKV_MAX_D = 64

#: An int, or a 0-d tensor (read on the device where it lives).
Active = Union[int, torch.Tensor]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  Raises when CUDA is asked for (or defaulted to) and absent."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return device


# ---------------------------------------------------------------------------
# Initializers matching torch semantics (`vit3d.py:44-75`).
# ---------------------------------------------------------------------------


def _uniform_(t: torch.Tensor, bound: float, g: torch.Generator) -> None:
    t.uniform_(-bound, bound, generator=g)


def _torch_linear_init(lin: nn.Linear, g: torch.Generator) -> None:
    """torch.nn.Linear default: U(+-1/sqrt(fan_in)) for weight and bias."""
    bound = 1.0 / math.sqrt(lin.in_features)
    _uniform_(lin.weight, bound, g)
    _uniform_(lin.bias, bound, g)


def _mlp_linear_init(lin: nn.Linear, g: torch.Generator) -> None:
    """Reference Mlp init: xavier_uniform weight, normal(std=1e-6) bias
    (`modeling.py:112-116`)."""
    bound = math.sqrt(6.0 / (lin.in_features + lin.out_features))
    _uniform_(lin.weight, bound, g)
    lin.bias.normal_(0.0, 1e-6, generator=g)


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ViTOutput:
    """Forward results (`modeling.py:287-288`): logits, per-layer attention
    maps, encoded tokens."""

    logits: torch.Tensor                   # (B, num_classes)
    attn_weights: Optional[torch.Tensor]   # (L, B, heads, T, T) or None
    tokens: torch.Tensor                   # (B, T, D) post final LayerNorm


class PatchEmbed(nn.Module):
    """Stride==kernel Conv3D patchify as a block reshape plus one matmul.

    The weight keeps the torch Conv3d layout (D, C, kh, kw, kz); patches are
    flattened in that same (C, kh, kw, kz) order, and tokens run h-major,
    then w, then z, as torch's `flatten(2)` on (B, D, gh, gw, gz).
    """

    def __init__(self, config: ViTConfig):
        super().__init__()
        self.config = config
        kh, kw, kz = config.patch_size
        D, C = config.hidden_size, config.in_channels
        self.weight = nn.Parameter(torch.empty(D, C, kh, kw, kz))
        self.bias = nn.Parameter(torch.empty(D))

    def reset_parameters(self, g: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.weight[0].numel())
        _uniform_(self.weight, bound, g)
        _uniform_(self.bias, bound, g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kh, kw, kz = self.config.patch_size
        B, H, W, Z, C = x.shape
        D = self.weight.shape[0]
        if H % kh == 0 and W % kw == 0 and Z % kz == 0:
            gh, gw, gz = H // kh, W // kw, Z // kz
            # (B, gh, kh, gw, kw, gz, kz, C) -> (B, gh, gw, gz, C, kh, kw, kz)
            p = x.reshape(B, gh, kh, gw, kw, gz, kz, C)
            p = p.permute(0, 1, 3, 5, 7, 2, 4, 6)
            p = p.reshape(B, gh * gw * gz, C * kh * kw * kz)
            return F.linear(p, self.weight.reshape(D, -1), self.bias)
        # general case: the strided conv itself
        out = F.conv3d(x.permute(0, 4, 1, 2, 3), self.weight, self.bias,
                       stride=self.config.patch_size)
        return out.flatten(2).transpose(1, 2)


def hybrid_patch_config(config: ViTConfig) -> ViTConfig:
    """The patchify config behind the hybrid stem (`vit3d.py:366-379`):
    patches of (H' // gh, W' // gw, 1) over the backbone's (H', W', Z, C')
    features."""
    h, w, c = feature_shape(config.img_size, config.resnet_block_units,
                            config.resnet_width_factor)
    gh, gw = config.hybrid_grid
    return dataclasses.replace(
        config, patch_size=(max(1, h // gh), max(1, w // gw), 1),
        in_channels=c, img_size=h)


class Embeddings(nn.Module):
    """Patchify + CLS + learned position embeddings (`modeling.py:127-175`).

    With `config.hybrid_grid` set, the ResNetV2 stem runs on every z-slice
    first (`hybrid_model`) and the patchify runs over its features; the
    position table then has the features' token count, not
    `config.seq_len`'s (`vit3d.py:388-392`)."""

    def __init__(self, config: ViTConfig):
        super().__init__()
        self.config = config
        D = config.hidden_size
        if config.hybrid_grid is not None:
            self.hybrid_model = HybridBackbone3D(
                config.resnet_block_units, config.resnet_width_factor,
                config.in_channels)
            patch_config = hybrid_patch_config(config)
        else:
            self.hybrid_model = None
            patch_config = config
        self.patch_embeddings = PatchEmbed(patch_config)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, D))
        self.position_embeddings = nn.Parameter(
            torch.zeros(1, patch_config.seq_len, D))

    def forward(self, x, *, deterministic: bool, generator=None):
        if self.hybrid_model is not None:
            x = self.hybrid_model(x)
        x = self.patch_embeddings(x)
        cls = self.cls_token.expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1) + self.position_embeddings
        return dropout(x, self.config.dropout_rate, deterministic, generator)


class Attention(nn.Module):
    """Multi-head self-attention (`modeling.py:55-99`)."""

    def __init__(self, config: ViTConfig):
        super().__init__()
        self.config = config
        D = config.hidden_size
        self.query = nn.Linear(D, D)
        self.key = nn.Linear(D, D)
        self.value = nn.Linear(D, D)
        self.out = nn.Linear(D, D)

    def forward(self, x, *, deterministic: bool, return_probs: bool,
                generator=None):
        cfg = self.config
        B, T, D = x.shape
        H = cfg.num_heads
        hd = D // H
        rate = cfg.attention_dropout_rate
        if (get_default_attention_impl() == "layer" and not return_probs
                and (deterministic or rate == 0.0)):
            # the whole sublayer on K3 (`vit3d.py:142-162`); with attention
            # dropout inactive the skipped dropouts draw nothing, so the
            # dropout stream is the einsum path's
            w = torch.cat([self.query.weight, self.key.weight,
                           self.value.weight])
            b = torch.cat([self.query.bias, self.key.bias, self.value.bias])
            return fused_attention_layer(x, w, b, self.out.weight,
                                         self.out.bias, H), None
        # int8 projections (`ops/quant.py`) on deterministic forwards only
        # (`vit3d.py:164-173`): the attention core stays in x's dtype
        use_int8 = (get_default_quant_impl() in ("int8", "int8_attn")
                    and deterministic)

        def project(x, w, b):
            return int8_dense(x, w.t(), b) if use_int8 else F.linear(x, w, b)

        if D <= _FUSED_QKV_MAX_D:
            # one (D, 3D) matmul, q|k|v along the output axis (`vit3d.py:181`)
            w = torch.cat([self.query.weight, self.key.weight,
                           self.value.weight])
            b = torch.cat([self.query.bias, self.key.bias, self.value.bias])
            qkv = project(x, w, b).view(B, T, 3, H, hd).permute(2, 0, 3, 1, 4)
            q, k, v = qkv[0], qkv[1], qkv[2]
        else:
            # separate projections; the kernel for this width (K4) reads the
            # (B, H, T, hd) views through their strides and hands back a
            # (B, T, H, hd) buffer, so neither transpose below copies
            q, k, v = (project(x, lin.weight, lin.bias).view(B, T, H, hd)
                       .transpose(1, 2)
                       for lin in (self.query, self.key, self.value))
        context, probs = dot_product_attention(
            q, k, v, dropout_p=rate, generator=generator,
            deterministic=deterministic, return_probs=return_probs)
        context = context.transpose(1, 2).reshape(B, T, D)
        out = project(context, self.out.weight, self.out.bias)
        return dropout(out, rate, deterministic, generator), probs


class Mlp(nn.Module):
    """GELU MLP with the reference's d >> D widths (`modeling.py:102-124`).

    Under the quant impl 'int8', on a deterministic forward without
    `mlp_active`, fc1 and fc2 are int8 products around the exact-erf GELU
    (`ops/quant.py`; `vit3d.py:284-293`), ahead of the kernel.  Otherwise,
    with dropout inactive and the MLP impl 'auto' on a CUDA tensor (or
    'kernel'), fc1 -> GELU -> fc2 runs as the fused kernel K1, which raises
    on a hidden size it does not take.  Otherwise the plain modules run,
    with the reference's dropout between GELU and fc2.
    """

    def __init__(self, config: ViTConfig):
        super().__init__()
        self.config = config
        self.fc1 = nn.Linear(config.hidden_size, config.mlp_dim)
        self.fc2 = nn.Linear(config.mlp_dim, config.hidden_size)

    def forward(self, x, *, deterministic: bool,
                mlp_active: Optional[Active] = None, generator=None):
        cfg = self.config
        if (get_default_quant_impl() == "int8" and deterministic
                and mlp_active is None):
            h = F.gelu(int8_dense(x, self.fc1.weight.t(), self.fc1.bias))
            return int8_dense(h, self.fc2.weight.t(), self.fc2.bias)
        impl = get_default_mlp_impl()
        dropout_off = deterministic or cfg.dropout_rate == 0.0
        if dropout_off and (impl == "kernel" or (impl == "auto" and x.is_cuda)):
            return fused_mlp(x, self.fc1.weight, self.fc1.bias,
                             self.fc2.weight, self.fc2.bias, mlp_active)
        h = F.gelu(self.fc1(x))  # exact erf, as torch's and the reference's
        if mlp_active is not None:
            col = torch.arange(cfg.mlp_dim, device=h.device)
            h = h * (col < mlp_active).to(h.dtype)
        h = dropout(h, cfg.dropout_rate, deterministic, generator)
        h = self.fc2(h)
        return dropout(h, cfg.dropout_rate, deterministic, generator)


def _scale(h: torch.Tensor, gate):
    """h * gate, where a gate of 1.0 is the identity and 0.0 gives exact 0."""
    if gate is None or (isinstance(gate, float) and gate == 1.0):
        return h
    return h * gate


class Block(nn.Module):
    """Pre-LN residual block (`modeling.py:178-197`).  `layer_gate` in {0, 1}
    scales both residual increments, so a gated block is an exact identity."""

    def __init__(self, config: ViTConfig):
        super().__init__()
        D = config.hidden_size
        self.attention_norm = nn.LayerNorm(D, eps=1e-6)
        self.attn = Attention(config)
        self.ffn_norm = nn.LayerNorm(D, eps=1e-6)
        self.ffn = Mlp(config)

    def forward(self, x, *, deterministic: bool, return_probs: bool,
                layer_gate=None, mlp_active: Optional[Active] = None,
                generator=None):
        h, probs = self.attn(self.attention_norm(x),
                             deterministic=deterministic,
                             return_probs=return_probs, generator=generator)
        x = x + _scale(h, layer_gate)
        h = self.ffn(self.ffn_norm(x), deterministic=deterministic,
                     mlp_active=mlp_active, generator=generator)
        x = x + _scale(h, layer_gate)
        return x, probs


def _layer_gate(num_layers_active: Optional[Active], i: int, like):
    if num_layers_active is None:
        return None
    if isinstance(num_layers_active, torch.Tensor):
        return (num_layers_active.to(like.device) > i).to(like.dtype)
    return 1.0 if i < num_layers_active else 0.0


class Encoder(nn.Module):
    """L pre-LN blocks and the final LayerNorm (`modeling.py:237-254`).
    `num_layers_active` gates trailing layers to identity at run time.

    `remat` recomputes each block's activations in the backward pass
    (`ops/attention.checkpoint_block`, JAX's `nn.remat`, `vit3d.py:443,
    468-469`): the same results, one block's activations held at a time
    instead of every layer's."""

    def __init__(self, config: ViTConfig, remat: bool = False):
        super().__init__()
        self.remat = remat
        self.layer = nn.ModuleList(Block(config)
                                   for _ in range(config.num_layers))
        self.encoder_norm = nn.LayerNorm(config.hidden_size, eps=1e-6)

    def forward(self, x, *, deterministic: bool, return_probs: bool,
                num_layers_active: Optional[Active] = None,
                mlp_active: Optional[Active] = None, generator=None):
        probs: List[torch.Tensor] = []
        remat = self.remat and torch.is_grad_enabled()
        for i, block in enumerate(self.layer):
            run = functools.partial(
                block, deterministic=deterministic, return_probs=return_probs,
                layer_gate=_layer_gate(num_layers_active, i, x),
                mlp_active=mlp_active, generator=generator)
            x, p = checkpoint_block(run, generator, x) if remat else run(x)
            if return_probs:
                probs.append(p)
        x = self.encoder_norm(x)
        return x, (torch.stack(probs) if return_probs else None)


class Transformer(nn.Module):
    """Embeddings + encoder: the reference's `transformer` submodule."""

    def __init__(self, config: ViTConfig, remat: bool = False):
        super().__init__()
        self.embeddings = Embeddings(config)
        self.encoder = Encoder(config, remat=remat)


class VisionTransformer3D(nn.Module):
    """Full baseline model (`modeling.py:269-344`).

    Parameters are drawn from `generator` (a CPU `torch.Generator`; seed 0
    when None) with the torch-default inits the JAX package mirrors, then
    moved to `device`: CUDA unless the caller names another.
    `zero_head=True`, the reference trainers' setting, zeroes the head, so
    logits start identically 0.  `vis=True` returns the attention maps.
    `remat` recomputes the encoder blocks in the backward pass (`Encoder`).
    """

    def __init__(self, config: ViTConfig, *, zero_head: bool = True,
                 vis: bool = True, device=None,
                 generator: Optional[torch.Generator] = None,
                 remat: bool = False):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.vis = vis
        self.transformer = Transformer(config, remat=remat)
        self.head = nn.Linear(config.hidden_size, config.num_classes)
        self.reset_parameters(zero_head, generator)
        self.to(device)

    @torch.no_grad()
    def reset_parameters(self, zero_head: bool,
                         generator: Optional[torch.Generator] = None) -> None:
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        emb = self.transformer.embeddings
        if emb.hybrid_model is not None:
            emb.hybrid_model.reset_parameters(g)
        emb.patch_embeddings.reset_parameters(g)
        emb.cls_token.zero_()
        emb.position_embeddings.zero_()
        for block in self.transformer.encoder.layer:
            for norm in (block.attention_norm, block.ffn_norm):
                norm.reset_parameters()
            for lin in (block.attn.query, block.attn.key, block.attn.value,
                        block.attn.out):
                _torch_linear_init(lin, g)
            _mlp_linear_init(block.ffn.fc1, g)
            _mlp_linear_init(block.ffn.fc2, g)
        self.transformer.encoder.encoder_norm.reset_parameters()
        if zero_head:
            self.head.weight.zero_()
            self.head.bias.zero_()
        else:
            _torch_linear_init(self.head, g)

    def forward(self, x: torch.Tensor, *, deterministic: bool = True,
                num_layers_active: Optional[Active] = None,
                mlp_active: Optional[Active] = None,
                generator: Optional[torch.Generator] = None) -> ViTOutput:
        """x: (B, H, W, Z, C) channels-last volumes."""
        x = self.transformer.embeddings(x, deterministic=deterministic,
                                        generator=generator)
        tokens, probs = self.transformer.encoder(
            x, deterministic=deterministic, return_probs=self.vis,
            num_layers_active=num_layers_active, mlp_active=mlp_active,
            generator=generator)
        logits = self.head(tokens[:, 0])
        return ViTOutput(logits=logits, attn_weights=probs, tokens=tokens)


def from_torch_layout(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W, Z) torch layout -> (B, H, W, Z, C) native layout."""
    return x.permute(0, 2, 3, 4, 1)
