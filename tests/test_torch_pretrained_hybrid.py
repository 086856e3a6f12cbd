"""The port's Google-ViT npz import and ResNetV2 hybrid stem against the JAX
package's, on the CPU.

Inputs and weights come from numpy with a seed.  JAX's models run with the
fused Pallas MLP in interpret mode, as `tests/test_torch_model.py` runs
them; JAX's inits cross over through the port's converter, with the
GroupNorm scales and biases, the position and CLS embeddings and the head
given values so that no part of the comparison is trivially one or zero.
"""

import os
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from vit3d_ensemble_tpu.configs import ViTConfig as JaxViTConfig
from vit3d_ensemble_tpu.models import VisionTransformer3D as JaxVisionTransformer3D
from vit3d_ensemble_tpu.models import resnet_hybrid as jax_resnet
from vit3d_ensemble_tpu.ops.mlp import set_default_mlp_impl as jax_set_mlp
from vit3d_ensemble_tpu.pretrained import load_from_npz as jax_load_from_npz
from vit3d_ensemble_tpu.pretrained import resample_posemb as jax_resample_posemb
from vit3d_ensemble_tpu_torch import pretrained
from vit3d_ensemble_tpu_torch.checkpoint import (
    _resnet_state_from_flax,
    vit_state_from_flax,
)
from vit3d_ensemble_tpu_torch.configs import ViTConfig
from vit3d_ensemble_tpu_torch.models import VisionTransformer3D
from vit3d_ensemble_tpu_torch.models import resnet_hybrid

REPO = pathlib.Path(__file__).resolve().parents[1]
ATOL = 2e-4          # `tests/test_model_parity.py:96-98`
RTOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: under xdist's six workers the default
    oversubscribes the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fake_vit_npz(L=2, D=16, H=4, mlp=32, ps=16, grid=3, rng=None):
    """A synthetic Google-ViT weight dict (2D, grid x grid patches), the
    layout of `tests/test_pretrained_and_hybrid.py:14-45`."""
    rng = rng or np.random.default_rng(0)
    n = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    w = {
        "embedding/kernel": n(ps, ps, 1, D),
        "embedding/bias": n(D),
        "cls": n(1, 1, D),
        "Transformer/posembed_input/pos_embedding": n(1, grid * grid + 1, D),
        "Transformer/encoder_norm/scale": n(D),
        "Transformer/encoder_norm/bias": n(D),
        "head/kernel": n(D, 1),
        "head/bias": n(1),
    }
    for i in range(L):
        r = f"Transformer/encoderblock_{i}"
        for name in ("query", "key", "value"):
            w[f"{r}/MultiHeadDotProductAttention_1/{name}/kernel"] = \
                n(D, H, D // H)
            w[f"{r}/MultiHeadDotProductAttention_1/{name}/bias"] = \
                n(H, D // H)
        w[f"{r}/MultiHeadDotProductAttention_1/out/kernel"] = n(H, D // H, D)
        w[f"{r}/MultiHeadDotProductAttention_1/out/bias"] = n(D)
        w[f"{r}/MlpBlock_3/Dense_0/kernel"] = n(D, mlp)
        w[f"{r}/MlpBlock_3/Dense_0/bias"] = n(mlp)
        w[f"{r}/MlpBlock_3/Dense_1/kernel"] = n(mlp, D)
        w[f"{r}/MlpBlock_3/Dense_1/bias"] = n(D)
        w[f"{r}/LayerNorm_0/scale"] = n(D)
        w[f"{r}/LayerNorm_0/bias"] = n(D)
        w[f"{r}/LayerNorm_2/scale"] = n(D)
        w[f"{r}/LayerNorm_2/bias"] = n(D)
    return w


def _jax_apply(model, variables, x, **kwargs):
    """JAX's model with the fused Pallas MLP in interpret mode, jitted (an
    eager flax apply of the stem dispatches op by op): its logits and
    tokens."""
    def run(variables, x):
        out = model.apply(variables, x, **kwargs)
        return out.logits, out.tokens

    jax_set_mlp("pallas")
    try:
        with pltpu.force_tpu_interpret_mode():
            logits, tokens = jax.jit(run)(variables, jnp.asarray(x))
    finally:
        jax_set_mlp("xla")
    return types.SimpleNamespace(logits=logits, tokens=tokens)


def _randomise_norms(tree, rng):
    """GroupNorm scales 1 + N(0, 0.1) and biases N(0, 0.1), in place: flax
    inits them to ones and zeros, under which a mix-up of two norms would
    not show."""
    for key, sub in tree.items():
        if isinstance(sub, dict) and "scale" in sub:
            sub["scale"] = (1 + 0.1 * rng.normal(size=sub["scale"].shape)).astype(np.float32)
            sub["bias"] = (0.1 * rng.normal(size=sub["bias"].shape)).astype(np.float32)
        elif isinstance(sub, dict):
            _randomise_norms(sub, rng)
    return tree


def _jax_init(module, x, seed=0):
    """A flax module's params (numpy, mutable), initialised under jit."""
    variables = jax.jit(module.init)(jax.random.key(seed), jnp.asarray(x))
    return jax.tree.map(np.array, jax.device_get(variables["params"]))


def _close(out, ref):
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=ATOL, rtol=RTOL)


# --- pretrained.py ----------------------------------------------------------


@pytest.mark.parametrize("tokens,new", [(10, 10), (10, 5), (197, 65)],
                         ids=["identity", "3x3_to_2x2", "14x14_to_8x8"])
def test_resample_posemb_matches_jax(tokens, new):
    p = np.random.default_rng(tokens).normal(size=(1, tokens, 8)).astype(np.float32)
    out = pretrained.resample_posemb(p, new)
    np.testing.assert_array_equal(out, jax_resample_posemb(p, new))
    assert out.shape == (1, new, 8)
    np.testing.assert_array_equal(out[:, 0], p[:, 0])


_NPZ_CFG = dict(patch_size=(16, 16, 5), hidden_size=16, num_heads=4,
                mlp_dim=32, num_layers=2, img_size=32)


@pytest.mark.parametrize("zero_head", [True, False])
def test_load_from_npz_matches_jax(zero_head):
    """Every tensor equal to JAX's tree taken through the converter; then
    the two models on the loaded weights agree."""
    weights = _fake_vit_npz()
    cfg, jcfg = ViTConfig(**_NPZ_CFG), JaxViTConfig(**_NPZ_CFG)
    state = pretrained.load_from_npz(weights, cfg, zero_head=zero_head)
    jparams = jax_load_from_npz(weights, jcfg, zero_head=zero_head)
    want = vit_state_from_flax(jparams, cfg)
    assert state.keys() == want.keys()
    for name, t in want.items():
        assert torch.equal(state[name], t), name
    emb = "transformer.embeddings"
    assert state[f"{emb}.position_embeddings"].shape == (1, 5, 16)
    w = state[f"{emb}.patch_embeddings.weight"]
    assert w.shape == (16, 1, 16, 16, 5)
    assert torch.all(w[..., [0, 1, 3, 4]] == 0) and torch.any(w[..., 2] != 0)
    assert torch.all(state["head.weight"] == 0) == zero_head

    model = VisionTransformer3D(cfg, vis=False, device="cpu")
    model.load_state_dict(state)
    model.eval()
    x = np.random.default_rng(1).normal(size=(2, 32, 32, 5, 1)).astype(np.float32)
    ref = _jax_apply(JaxVisionTransformer3D(jcfg, vis=False),
                     {"params": jax.tree.map(jnp.asarray, jparams)}, x,
                     deterministic=True)
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    _close(out.tokens, ref.tokens)
    _close(out.logits, ref.logits)


def test_load_from_npz_refuses_a_hybrid_config():
    cfg = ViTConfig(**_NPZ_CFG, hybrid_grid=(2, 2))
    with pytest.raises(ValueError, match="hybrid"):
        pretrained.load_from_npz(_fake_vit_npz(), cfg)


def test_pretrained_imports_scipy_only_when_resampling():
    code = ("import sys\n"
            "import vit3d_ensemble_tpu_torch.pretrained\n"
            "import vit3d_ensemble_tpu_torch.models.resnet_hybrid\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('scipy', 'jax', 'flax', 'vit3d_ensemble_tpu')))\n")
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"


# --- models/resnet_hybrid.py ------------------------------------------------


def _torch_module(module, state):
    module.load_state_dict(state)
    return module.eval()


def test_std_conv_matches_jax():
    x = np.random.default_rng(2).normal(size=(2, 17, 17, 8)).astype(np.float32)
    jconv = jax_resnet.StdConv(12, (3, 3), strides=2, use_bias=False, padding=1)
    params = _jax_init(jconv, x)
    conv = _torch_module(resnet_hybrid.StdConv2d(8, 12, 3, stride=2, padding=1),
                         {"weight": torch.from_numpy(
                             params["kernel"].transpose(3, 2, 0, 1).copy())})
    ref = jax.jit(jconv.apply)({"params": params}, jnp.asarray(x))
    _close(conv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1), ref)


def test_strided_bottleneck_matches_jax():
    """A unit with the projection (stride 2, 64 -> 256 channels)."""
    x = np.random.default_rng(3).normal(size=(2, 16, 16, 64)).astype(np.float32)
    jblock = jax_resnet.PreActBottleneck(cout=256, cmid=64, stride=2)
    params = _randomise_norms(_jax_init(jblock, x), np.random.default_rng(4))
    state = {k.removeprefix("body.block1.unit1."): v for k, v in
             _resnet_state_from_flax({"block1_unit1": params}, "").items()}
    block = _torch_module(resnet_hybrid.PreActBottleneck(64, 256, 64, stride=2),
                          state)
    assert block.downsample is not None
    ref = jax.jit(jblock.apply)({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        out = block(torch.from_numpy(x).permute(0, 3, 1, 2))
    _close(out.permute(0, 2, 3, 1), ref)


def test_resnet_v2_matches_jax():
    """ResNetV2 with one unit a stage on (2, 64, 64, 1): JAX's init carried
    across, the features and the shape helper's geometry."""
    x = np.random.default_rng(5).normal(size=(2, 64, 64, 1)).astype(np.float32)
    jmodel = jax_resnet.ResNetV2(block_units=(1, 1, 1))
    params = _randomise_norms(_jax_init(jmodel, x), np.random.default_rng(6))
    model = _torch_module(resnet_hybrid.ResNetV2((1, 1, 1)),
                          _resnet_state_from_flax(params, ""))
    ref = jax.jit(jmodel.apply)({"params": params}, jnp.asarray(x))
    assert ref.shape == (2, 4, 4, 1024)
    assert resnet_hybrid.feature_shape(64, (1, 1, 1), 1) == (4, 4, 1024)
    assert resnet_hybrid.feature_shape(128, (3, 4, 9), 1) == (8, 8, 1024)
    with torch.no_grad():
        out = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    _close(out.permute(0, 2, 3, 1), ref)


def test_group_norm_variance_differs_from_flax():
    """flax's GroupNorm takes E[x^2] - E[x]^2 (`use_fast_variance`), torch's
    (on a contiguous NCHW tensor, as the stem hands it) the centred sum; on
    activations of mean 10 and scale 1 the two part by this much, where
    flax's two-pass variance agrees with torch's to f32 rounding.  Printed
    with -s."""
    import flax.linen as fnn

    x = (10 + np.random.default_rng(7).normal(size=(4, 8, 8, 64))).astype(np.float32)
    variables = {"params": {"scale": np.ones(64, np.float32),
                            "bias": np.zeros(64, np.float32)}}
    fast = np.asarray(fnn.GroupNorm(32, epsilon=1e-6).apply(variables, x))
    exact = np.asarray(fnn.GroupNorm(32, epsilon=1e-6, use_fast_variance=False)
                       .apply(variables, x))
    gn = resnet_hybrid._gn(64).eval()
    with torch.no_grad():
        out = gn(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    out = out.permute(0, 2, 3, 1).numpy()
    dev_fast, dev_exact = np.abs(out - fast).max(), np.abs(out - exact).max()
    print(f"group norm, mean 10: torch vs flax fast variance {dev_fast:.3g}, "
          f"vs two-pass {dev_exact:.3g}")
    assert dev_exact <= 1e-5
    assert dev_fast <= 1e-3


# --- the hybrid ViT ---------------------------------------------------------

_HYBRID = dict(patch_size=(16, 16, 5), hidden_size=16, num_heads=4,
               mlp_dim=32, num_layers=1, img_size=64, hybrid_grid=(2, 2),
               resnet_block_units=(1, 1, 1), dropout_rate=0.0)
_HYBRID_PAIR = {}


def _hybrid_pair():
    """(JAX model, its numpy params, the port's model on the CPU, config)."""
    if not _HYBRID_PAIR:
        jcfg, cfg = JaxViTConfig(**_HYBRID), ViTConfig(**_HYBRID)
        jmodel = JaxVisionTransformer3D(jcfg, zero_head=False, vis=False)
        x = jnp.zeros((1, 64, 64, 5, 1), jnp.float32)
        params = jax.tree.map(np.array, jax.device_get(
            jax.jit(jmodel.init)(jax.random.key(0), x)["params"]))
        rng = np.random.default_rng(8)
        _randomise_norms(params["embeddings"]["hybrid_model"], rng)
        emb = params["embeddings"]
        for name in ("position_embeddings", "cls_token"):
            emb[name] = (0.02 * rng.normal(size=emb[name].shape)).astype(np.float32)
        model = VisionTransformer3D(cfg, zero_head=False, vis=False, device="cpu")
        model.load_state_dict(vit_state_from_flax(params, cfg))
        model.eval()
        _HYBRID_PAIR.update(jmodel=jmodel, params=params, model=model, cfg=cfg)
    return _HYBRID_PAIR


def _hybrid_input(seed, B=2):
    return np.random.default_rng(seed).normal(size=(B, 64, 64, 5, 1)).astype(np.float32)


def test_hybrid_vit_matches_jax():
    """Logits and tokens within 2e-4; the position table's length from the
    backbone's geometry (4 x 4 features, patches of 2 x 2 x 1: 2 * 2 * 5
    tokens and CLS), not from `seq_len`'s pure patchify (4 * 4 * 1 + 1)."""
    pair = _hybrid_pair()
    model, cfg = pair["model"], pair["cfg"]
    emb = model.transformer.embeddings
    assert emb.position_embeddings.shape == (1, 21, 16)
    assert cfg.seq_len == 17
    assert emb.patch_embeddings.weight.shape == (16, 1024, 2, 2, 1)
    names = {k for k in model.state_dict() if ".hybrid_model." in k}
    assert "transformer.embeddings.hybrid_model.root.conv.weight" in names
    assert "transformer.embeddings.hybrid_model.body.block3.unit1.gn_proj.bias" in names
    x = _hybrid_input(9)
    ref = _jax_apply(pair["jmodel"], {"params": pair["params"]}, x,
                     deterministic=True)
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    assert out.tokens.shape == (2, 21, 16)
    _close(out.tokens, ref.tokens)
    _close(out.logits, ref.logits)


def test_hybrid_vit_init_is_seeded_and_flax_like():
    cfg = ViTConfig(**_HYBRID)
    a, b = (VisionTransformer3D(cfg, device="cpu",
                                generator=torch.Generator().manual_seed(3))
            for _ in range(2))
    for (name, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(pa, pb), name
    stem = a.transformer.embeddings.hybrid_model
    w = stem.root.conv.weight                     # fan_in 49
    assert w.abs().max() <= 2 / 0.87962566103423978 / 7 + 1e-6
    assert abs(float(w.detach().std()) - 1 / 7) < 0.03
    assert torch.all(stem.body.block1.unit1.gn1.weight == 1)
    assert torch.all(stem.body.block1.unit1.gn1.bias == 0)


def test_hybrid_vit_gradients_match_jax():
    """The BCE loss's gradient with respect to every parameter of the stem
    and the encoder, against `jax.grad`: within 2e-4 of each tensor's
    largest entry.  The key projection's bias is held to the largest
    gradient of all instead: softmax over keys ignores a shift shared by
    every key, so its gradient is 0 but for rounding in both frameworks."""
    pair = _hybrid_pair()
    model, cfg = pair["model"], pair["cfg"]
    x = _hybrid_input(10)
    y = np.array([[1.0], [0.0]], np.float32)

    def jax_loss(params):
        z = _jax_apply(pair["jmodel"], {"params": params}, x,
                       deterministic=True).logits
        return jnp.mean(jax.nn.softplus(z) - y * z)

    jgrads = jax.device_get(jax.jit(jax.grad(jax_loss))(pair["params"]))
    want = vit_state_from_flax(jgrads, cfg)
    model.zero_grad()
    z = model(torch.from_numpy(x)).logits
    torch.mean(torch.nn.functional.softplus(z) - torch.from_numpy(y) * z).backward()
    got = dict(model.named_parameters())
    assert any(".hybrid_model." in n for n in want)
    largest = max(float(g.abs().max()) for g in want.values())
    for name, g in want.items():
        scale = largest if name.endswith("attn.key.bias") else float(g.abs().max())
        err = float((got[name].grad - g).abs().max())
        assert err <= ATOL * max(scale, 1e-12), (name, err, scale)
