"""The stacked model: the P = G·F cells of a sweep group in one forward.

The counterpart of the sweep engine's `jax.vmap(jax.vmap(model.apply))`
(`vit3d_ensemble_tpu/sweep/engine.py:227-237`) over the padded template of a
(hidden, heads) shape class.  Parameters are a dict of tensors with a
leading model axis P under the template's `state_dict` names
(`transformer.encoder.layer.{i}.ffn.fc1.weight` is (P, M, D)), as
`stack.init_group_params` gives them with (G, F) flattened to P.  Model p is
config p // F on fold p % F.

The math is `models/vit3d.VisionTransformer3D`'s with a leading P on every
tensor:
  * the linears (patchify, QKV, out projection, head) are batched products
    (`torch.baddbmm`, `torch.matmul`);
  * LayerNorm is `F.layer_norm` without affine, then the stacked scale and
    bias;
  * the attention core folds P into the batch, so K2 (impl `auto`) and K3
    (`layer`) run unchanged on (P·B, T, ...);
  * the MLP calls `ops/fused_mlp.fused_mlp` with the model axis and the
    (P,) `mlp_active` where the unstacked model calls it (dropout inactive,
    impl `auto` on a CUDA tensor or `kernel`): K1, or the variant that
    `_MLP_VARIANT` names;
  * `layers_active`, a (P,) tensor, gates each block per model
    (`models/vit3d.py:237-275` has the scalar form);
  * under the quant impls `int8` and `int8_attn` a deterministic forward
    outside `layer` takes the QKV and out projections as int8 products
    with each model's scales (`ops/quant.int8_dense` with the model axis).

Why an explicit leading axis and not `torch.func.vmap`: the kernels are
ctypes launches inside `autograd.Function`s, which under `vmap` would need
hand-written `setup_context` and `vmap` rules each, and dropout drawn from an
explicit generator does not run under `vmap`.  The explicit axis needs
neither, and launches each kernel once for all P models.

Dropout takes its masks from the `generator` it is given: the sweep
engine's `ops/attention.CellDropout`, a stream for each cell keyed on the
cell's index in the true (config, fold) grid, so a cell's masks do not
depend on P or on its place in the stack.  (A `torch.Generator` also
serves; it draws one mask a site for the whole (P, ...) tensor.)
"""

from __future__ import annotations

import functools
from typing import Mapping

import torch
import torch.nn.functional as F

from vit3d_ensemble_tpu_torch.configs import ViTConfig
from vit3d_ensemble_tpu_torch.ops import attention_layer
from vit3d_ensemble_tpu_torch.ops.attention import (
    checkpoint_block,
    dot_product_attention,
    dropout,
    get_default_attention_impl,
)
from vit3d_ensemble_tpu_torch.ops.fused_mlp import fused_mlp
from vit3d_ensemble_tpu_torch.ops.mlp import get_default_mlp_impl
from vit3d_ensemble_tpu_torch.ops.quant import get_default_quant_impl, int8_dense

Params = Mapping[str, torch.Tensor]


def _linear(x, w, b):
    """x (P, ..., in) @ w (P, out, in)^T + b (P, out), one product a model."""
    P = w.shape[0]
    out = torch.baddbmm(b.unsqueeze(1), x.reshape(P, -1, x.shape[-1]),
                        w.transpose(1, 2))
    return out.reshape(*x.shape[:-1], w.shape[1])


def _layer_norm(x, w, b):
    """LayerNorm over D with eps 1e-6, then each model's scale and bias."""
    shape = (w.shape[0],) + (1,) * (x.dim() - 2) + (w.shape[1],)
    y = F.layer_norm(x, x.shape[-1:], eps=1e-6)
    return y * w.reshape(shape) + b.reshape(shape)


def _patchify(config: ViTConfig, x: torch.Tensor) -> torch.Tensor:
    """(S, B, H, W, Z, C) volumes -> (S, B, T - 1, C·kh·kw·kz) patches in
    `models/vit3d.PatchEmbed`'s order."""
    kh, kw, kz = config.patch_size
    S, B, H, W, Z, C = x.shape
    if H % kh or W % kw or Z % kz:
        raise ValueError(f"stacked model: volume {(H, W, Z)} is not a whole "
                         f"number of patches {config.patch_size}")
    gh, gw, gz = H // kh, W // kw, Z // kz
    p = x.reshape(S, B, gh, kh, gw, kw, gz, kz, C)
    p = p.permute(0, 1, 2, 4, 6, 8, 3, 5, 7)
    return p.reshape(S, B, gh * gw * gz, C * kh * kw * kz)


def _attention(config, params, pre, h, *, deterministic, generator):
    """The attention sublayer of every model: h (P, B, T, D) normed tokens."""
    P, B, T, D = h.shape
    H = config.num_heads
    rate = config.attention_dropout_rate
    w = torch.cat([params[f"{pre}.attn.{n}.weight"]
                   for n in ("query", "key", "value")], dim=1)
    b = torch.cat([params[f"{pre}.attn.{n}.bias"]
                   for n in ("query", "key", "value")], dim=1)
    layer = get_default_attention_impl() == "layer" and (deterministic or rate == 0.0)
    # int8 projections on deterministic forwards outside `layer`, each
    # model with its own scales, as JAX's vmapped module takes them; the
    # MLP stays exact, since `mlp_active` is always set here
    use_int8 = (not layer and deterministic
                and get_default_quant_impl() in ("int8", "int8_attn"))

    def project(x, w, b):
        return int8_dense(x, w.transpose(1, 2), b) if use_int8 else _linear(x, w, b)

    qkv = project(h, w, b).reshape(P * B, T, 3 * D)
    if layer:
        # K3's core on the (P·B, T, 3D) QKV output, read in place
        ctx = attention_layer.attention_core(*attention_layer._split(qkv), H)
    else:
        q, k, v = qkv.view(P * B, T, 3, H, D // H).permute(2, 0, 3, 1, 4)
        ctx, _ = dot_product_attention(q, k, v, dropout_p=rate,
                                       generator=generator,
                                       deterministic=deterministic)
        ctx = ctx.transpose(1, 2).reshape(P * B, T, D)
    out = project(ctx.reshape(P, B, T, D), params[f"{pre}.attn.out.weight"],
                  params[f"{pre}.attn.out.bias"])
    return dropout(out, rate, deterministic, generator)


def _mlp(config, params, pre, h, mlp_active, *, deterministic, generator):
    """The FFN of every model, columns past each model's width masked."""
    P, B, T, D = h.shape
    rate = config.dropout_rate
    w1, b1 = params[f"{pre}.ffn.fc1.weight"], params[f"{pre}.ffn.fc1.bias"]
    w2, b2 = params[f"{pre}.ffn.fc2.weight"], params[f"{pre}.ffn.fc2.bias"]
    impl = get_default_mlp_impl()
    if (deterministic or rate == 0.0) and (
            impl == "kernel" or (impl == "auto" and h.is_cuda)):
        return fused_mlp(h.reshape(P, B * T, D), w1, b1, w2, b2,
                         mlp_active).reshape(P, B, T, D)
    a = F.gelu(_linear(h, w1, b1))
    cols = torch.arange(a.shape[-1], device=a.device)
    a = a * (cols < mlp_active.reshape(P, 1, 1, 1)).to(a.dtype)
    a = dropout(a, rate, deterministic, generator)
    return dropout(_linear(a, w2, b2), rate, deterministic, generator)


def _block(h, config, params, pre, gate, mlp_active, deterministic, generator):
    """Block `pre` of every model: the gated attention and FFN residuals."""
    a = _attention(config, params, pre,
                   _layer_norm(h, params[f"{pre}.attention_norm.weight"],
                               params[f"{pre}.attention_norm.bias"]),
                   deterministic=deterministic, generator=generator)
    h = h + a * gate
    a = _mlp(config, params, pre,
             _layer_norm(h, params[f"{pre}.ffn_norm.weight"],
                         params[f"{pre}.ffn_norm.bias"]),
             mlp_active, deterministic=deterministic, generator=generator)
    return h + a * gate


def stacked_forward(params: Params, config: ViTConfig, x: torch.Tensor, *,
                    layers_active: torch.Tensor, mlp_active: torch.Tensor,
                    deterministic: bool = True,
                    generator=None, remat: bool = False) -> torch.Tensor:
    """Logits (P, B, num_classes) of the P stacked models.

    x: (S, B, H, W, Z, C) channels-last volumes, S dividing P: model p reads
    x[p % S], so the sweep's per-fold batches (S = F) serve every config of
    the group.  `layers_active`, `mlp_active`: (P,) int tensors on x's device.
    `config` is the group's template (its depth and widths are the padded
    ones).  `remat` recomputes each block in the backward pass
    (`ops/attention.checkpoint_block`; the generator's masks replayed).
    """
    P = params["head.weight"].shape[0]
    S, B = x.shape[:2]
    if P % S:
        raise ValueError(f"stacked model: {S} input sets for {P} models")
    D = config.hidden_size
    root = "transformer.embeddings"

    patches = _patchify(config, x)                      # (S, B, Tp, K)
    w = params[f"{root}.patch_embeddings.weight"].reshape(P // S, S, D, -1)
    tokens = torch.matmul(patches.reshape(S, -1, patches.shape[-1]),
                          w.transpose(-1, -2))          # (P // S, S, B·Tp, D)
    tokens = tokens.reshape(P, B, -1, D) + params[
        f"{root}.patch_embeddings.bias"].reshape(P, 1, 1, D)
    cls = params[f"{root}.cls_token"].reshape(P, 1, 1, D).expand(P, B, 1, D)
    pos = params[f"{root}.position_embeddings"].reshape(P, 1, -1, D)
    h = torch.cat([cls, tokens], dim=2) + pos
    h = dropout(h, config.dropout_rate, deterministic, generator)

    remat = remat and torch.is_grad_enabled()
    for i in range(config.num_layers):
        gate = (layers_active > i).to(h.dtype).reshape(P, 1, 1, 1)
        run = functools.partial(_block, config=config, params=params,
                                pre=f"transformer.encoder.layer.{i}", gate=gate,
                                mlp_active=mlp_active, deterministic=deterministic,
                                generator=generator)
        h = checkpoint_block(run, generator, h) if remat else run(h)
    h = _layer_norm(h, params["transformer.encoder.encoder_norm.weight"],
                    params["transformer.encoder.encoder_norm.bias"])
    return _linear(h[:, :, 0], params["head.weight"], params["head.bias"])

