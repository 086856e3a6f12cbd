"""The port's models against the JAX package's, on the CPU, and the rules
the port keeps.

Weights come from the JAX package's own init, with the position and CLS
embeddings and the head randomised so that no part of the comparison is
trivially zero, and cross over through the port's converter.  The JAX
models run with the fused Pallas MLP in interpret mode, as the JAX package's
own tests run it; the selector is restored afterwards.
"""

import ast
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from vit3d_ensemble_tpu.configs import ViTConfig as JaxViTConfig
from vit3d_ensemble_tpu.models import (
    TransformerEnsemble as JaxTransformerEnsemble,
    VisionTransformer3D as JaxVisionTransformer3D,
)
from vit3d_ensemble_tpu.ops.mlp import set_default_mlp_impl as jax_set_mlp
from vit3d_ensemble_tpu_torch.checkpoint import (
    ensemble_state_from_flax,
    vit_state_from_flax,
)
from vit3d_ensemble_tpu_torch.configs import ViTConfig
from vit3d_ensemble_tpu_torch.models import (
    TransformerEnsemble,
    VisionTransformer3D,
)
from vit3d_ensemble_tpu_torch.models.vit3d import from_torch_layout
from vit3d_ensemble_tpu_torch.ops import fused_attention, fused_mlp
from vit3d_ensemble_tpu_torch.ops import mlp as mlp_select

REPO = pathlib.Path(__file__).resolve().parents[1]


def _volumes(seed, B=2):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(B, 128, 128, 5, 1)).astype(np.float32)


def _randomise(params, seed):
    """Position and CLS embeddings and the head init to zero in both
    frameworks; give them values (`tests/test_model_parity.py:70-78`)."""
    rng = np.random.default_rng(seed)
    emb = params["embeddings"]
    for name in ("position_embeddings", "cls_token"):
        emb[name] = (rng.normal(size=emb[name].shape) * 0.02).astype(np.float32)
    for name in ("kernel", "bias"):
        params["head"][name] = rng.normal(
            size=params["head"][name].shape).astype(np.float32)
    return params


def _jax_apply(model, params, x, **kwargs):
    jax_set_mlp("pallas")
    try:
        with pltpu.force_tpu_interpret_mode():
            return model.apply({"params": params}, jnp.asarray(x),
                               deterministic=True, **kwargs)
    finally:
        jax_set_mlp("xla")


_PAIRS = {}


def _pair(conf):
    """(JAX model, its numpy params, the port's model on the CPU)."""
    if conf not in _PAIRS:
        jmodel = JaxVisionTransformer3D(JaxViTConfig.from_conf(conf),
                                        zero_head=False, vis=True)
        x = jnp.zeros((1, 128, 128, 5, 1), jnp.float32)
        params = jax.device_get(
            jax.jit(jmodel.init)(jax.random.key(conf), x)["params"])
        params = _randomise(params, conf)
        cfg = ViTConfig.from_conf(conf)
        tmodel = VisionTransformer3D(cfg, zero_head=True, vis=True,
                                     device="cpu")
        tmodel.load_state_dict(vit_state_from_flax(params, cfg))
        tmodel.eval()
        _PAIRS[conf] = (jmodel, params, tmodel)
    return _PAIRS[conf]


@pytest.mark.parametrize("conf", [1, 2, 3, 18])
def test_vit_matches_jax(conf):
    """One model per (D, H) class (hd 16, 4, 1) and conf 18 (M=3072, L=8)."""
    jmodel, params, tmodel = _pair(conf)
    x = _volumes(conf)
    ref = _jax_apply(jmodel, params, x)
    with torch.no_grad():
        out = tmodel(torch.from_numpy(x))
    np.testing.assert_allclose(out.logits.numpy(), np.asarray(ref.logits),
                               atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(out.tokens.numpy(), np.asarray(ref.tokens),
                               atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(out.attn_weights.numpy(),
                               np.asarray(ref.attn_weights), atol=1e-5,
                               rtol=1e-4)
    assert out.attn_weights.shape == (ViTConfig.from_conf(conf).num_layers,
                                      2, ViTConfig.from_conf(conf).num_heads,
                                      65, 65)


@pytest.mark.parametrize("mlp_impl", ["auto", "plain", "kernel"])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_vit_masks_match_jax(as_tensor, mlp_impl):
    """Runtime depth and width masks: conf 18 run as 5 layers of 2000
    columns, through every MLP impl (on the CPU all compute plain math)."""
    jmodel, params, tmodel = _pair(18)
    x = _volumes(7)
    ref = _jax_apply(jmodel, params, x, num_layers_active=jnp.int32(5),
                     mlp_active=jnp.int32(2000))
    la, ma = (torch.tensor(5), torch.tensor(2000)) if as_tensor else (5, 2000)
    mlp_select.set_default_mlp_impl(mlp_impl)
    try:
        with torch.no_grad():
            out = tmodel(torch.from_numpy(x), num_layers_active=la,
                         mlp_active=ma)
    finally:
        mlp_select.set_default_mlp_impl("auto")
    np.testing.assert_allclose(out.logits.numpy(), np.asarray(ref.logits),
                               atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(out.tokens.numpy(), np.asarray(ref.tokens),
                               atol=2e-4, rtol=1e-4)


def test_gated_layers_are_identity():
    """A model run with num_layers_active=k equals its first k layers."""
    _, params, tmodel = _pair(3)
    cfg = ViTConfig.from_conf(3)
    short = VisionTransformer3D(
        dataclasses.replace(cfg, num_layers=2), vis=False,
        device="cpu")
    state = {k: v for k, v in tmodel.state_dict().items()
             if not k.startswith(("transformer.encoder.layer.2",
                                  "transformer.encoder.layer.3"))}
    short.load_state_dict(state)
    x = torch.from_numpy(_volumes(9))
    with torch.no_grad():
        a = tmodel(x, num_layers_active=2).tokens
        b = short(x).tokens
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_channels_first_input_and_patch_order():
    """from_torch_layout + the reshape patchify equal torch's Conv3d on the
    (B, C, H, W, Z) layout, and the strided-conv branch agrees with it."""
    _, _, tmodel = _pair(2)
    pe = tmodel.transformer.embeddings.patch_embeddings
    x = torch.from_numpy(_volumes(11)).permute(0, 4, 1, 2, 3)
    conv = torch.nn.functional.conv3d(x, pe.weight, pe.bias, stride=(16, 16, 5))
    ref = conv.flatten(2).transpose(1, 2)
    with torch.no_grad():
        torch.testing.assert_close(pe(from_torch_layout(x)), ref,
                                   atol=1e-5, rtol=1e-5)
        # 120 px is not a multiple of 16: the strided-conv branch
        odd = from_torch_layout(x)[:, :120, :120]
        conv = torch.nn.functional.conv3d(odd.permute(0, 4, 1, 2, 3),
                                          pe.weight, pe.bias,
                                          stride=(16, 16, 5))
        torch.testing.assert_close(pe(odd), conv.flatten(2).transpose(1, 2))


def test_ensemble_matches_jax():
    confs = (5, 9, 11)
    jcfgs = tuple(JaxViTConfig.from_conf(c) for c in confs)
    jens = JaxTransformerEnsemble(jcfgs, zero_head=False)
    params = jax.device_get(jax.jit(jens.init)(
        jax.random.key(0), jnp.zeros((1, 128, 128, 5, 1), jnp.float32))[
            "params"])
    for i in range(len(confs)):
        _randomise(params[f"transformer_{i}"], 20 + i)
    cfgs = tuple(ViTConfig.from_conf(c) for c in confs)
    tens = TransformerEnsemble(cfgs, device="cpu")
    tens.load_state_dict(ensemble_state_from_flax(params, cfgs))
    tens.eval()
    x = _volumes(12, B=3)
    masks = [(3, 1500), (None, None), (5, 2048)]
    for kwargs, tmasks in (({}, None),
                           ({"member_masks": [(jnp.int32(a) if a else None,
                                               jnp.int32(m) if m else None)
                                              for a, m in masks]}, masks)):
        ref = _jax_apply(jens, params, x, **kwargs)
        with torch.no_grad():
            out = tens(torch.from_numpy(x), member_masks=tmasks)
        assert out.shape == (3, 1)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5,
                                   rtol=1e-4)


def test_state_dict_names_are_the_reference_names():
    cfg = ViTConfig.from_conf(1)
    keys = set(VisionTransformer3D(cfg, device="cpu").state_dict())
    assert "transformer.encoder.layer.0.attn.query.weight" in keys
    assert "transformer.embeddings.patch_embeddings.weight" in keys
    assert "head.weight" in keys
    ens = TransformerEnsemble((cfg, cfg), device="cpu").state_dict()
    assert {"classifier.weight", "classifier.bias"} <= set(ens)
    assert ens["classifier.weight"].shape == (1, 2)
    assert "transformers.1.transformer.encoder.encoder_norm.bias" in ens


def test_init_follows_torch_defaults_and_seed():
    cfg = ViTConfig.from_conf(4)
    a = VisionTransformer3D(cfg, device="cpu",
                            generator=torch.Generator().manual_seed(3))
    b = VisionTransformer3D(cfg, device="cpu",
                            generator=torch.Generator().manual_seed(3))
    for (name, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(pa, pb), name
    blk = a.transformer.encoder.layer[0]
    assert blk.attention_norm.eps == 1e-6
    assert blk.attn.query.weight.abs().max() <= 1 / 8      # 1/sqrt(64)
    assert blk.ffn.fc1.bias.abs().max() < 1e-4             # normal(1e-6)
    assert torch.all(a.head.weight == 0)                   # zero_head
    assert torch.all(a.transformer.embeddings.position_embeddings == 0)


def test_hybrid_config_is_not_ported():
    cfg = ViTConfig(hybrid_grid=(8, 8))
    with pytest.raises(NotImplementedError, match="hybrid"):
        VisionTransformer3D(cfg, device="cpu")


def test_entry_points_need_a_card_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ViTConfig.from_conf(3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VisionTransformer3D(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TransformerEnsemble((cfg,))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VisionTransformer3D(cfg, device="cuda")
    assert next(VisionTransformer3D(cfg, device="cpu").parameters()).is_cpu


def test_cpu_forward_launches_no_kernel(monkeypatch):
    monkeypatch.setattr(fused_mlp, "launches", 0)
    monkeypatch.setattr(fused_attention, "launches", 0)
    _, _, tmodel = _pair(1)
    mlp_select.set_default_mlp_impl("kernel")
    try:
        with torch.no_grad():
            tmodel(torch.from_numpy(_volumes(13)))
    finally:
        mlp_select.set_default_mlp_impl("auto")
    assert (fused_mlp.launches, fused_attention.launches) == (0, 0)


def test_port_imports_no_jax():
    """Importing the port loads no jax, flax or vit3d_ensemble_tpu module,
    and none of pandas, sklearn or PIL, which the card's host lacks."""
    code = (
        "import sys\n"
        "import vit3d_ensemble_tpu_torch, vit3d_ensemble_tpu_torch.models, "
        "vit3d_ensemble_tpu_torch.ops, vit3d_ensemble_tpu_torch.checkpoint, "
        "vit3d_ensemble_tpu_torch.ops.fused_mlp, "
        "vit3d_ensemble_tpu_torch.ops.fused_attention, "
        "vit3d_ensemble_tpu_torch.ops.attention_layer, "
        "vit3d_ensemble_tpu_torch.ops._build, "
        "vit3d_ensemble_tpu_torch.data, vit3d_ensemble_tpu_torch.metrics, "
        "vit3d_ensemble_tpu_torch.train.trainer, "
        "vit3d_ensemble_tpu_torch.train.ensemble_trainer, "
        "vit3d_ensemble_tpu_torch.utils.metrics_log\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'vit3d_ensemble_tpu', 'pandas', 'sklearn', "
        "'PIL'))\n"
        "print(repr(bad))\n")
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"


def test_port_sources_import_no_jax():
    """No file of the port, nor chip_smoke.py, imports jax, flax or the JAX
    package, even lazily inside a function."""
    files = sorted((REPO / "vit3d_ensemble_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in (
                    "jax", "jaxlib", "flax", "vit3d_ensemble_tpu"), (
                    f"{path.relative_to(REPO)} imports {name}")
