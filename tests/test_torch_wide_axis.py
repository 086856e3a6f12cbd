"""K1's wide bodies with a model axis, and K1b and K1c at every wide hidden
size, on the CPU.

The plain versions of K1, K1b and K1c (what the wrappers compute on a CPU
tensor, and what the card's kernels are held to) at wide D with a model
axis against `jax.vmap(pallas_mlp.fused_mlp)` in interpret mode under each
JAX variant; the stacked model at a wide toy config against JAX's vmapped
model on its pallas MLP; the wide plans (`wide_f32_plan`, `k1c_wide_plan`)
as pure Python; and the width mask kept on the device.  The kernels
themselves run on the card (`tests/test_torch_kernels.py`, `chip_smoke.py`).
"""

import heapq

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from vit3d_ensemble_tpu.configs import ViTConfig as JaxViTConfig
from vit3d_ensemble_tpu.models import VisionTransformer3D as JaxVisionTransformer3D
from vit3d_ensemble_tpu.ops import mlp as jax_mlp_select
from vit3d_ensemble_tpu.ops import pallas_mlp
from vit3d_ensemble_tpu_torch.checkpoint import vit_state_from_flax
from vit3d_ensemble_tpu_torch.configs import ViTConfig
from vit3d_ensemble_tpu_torch.ops import fused_mlp
from vit3d_ensemble_tpu_torch.ops import mlp as mlp_select
from vit3d_ensemble_tpu_torch.sweep.stacked import stacked_forward

VARIANTS = ("seq", "chunked", "pipelined2")
PLAIN = {"seq": fused_mlp._plain_mlp, "chunked": fused_mlp._plain_mlp_chunked,
         "pipelined2": fused_mlp._plain_mlp}
#: the JAX tolerances of `tests/test_pallas_mlp.py`: f32, and bf16 (the JAX
#: bf16 kernel's polynomial GELU, rounded where the kernels round)
TOL = {"float32": dict(atol=2e-5, rtol=1e-4), "bfloat16": dict(atol=0.05, rtol=0.05)}
SMS = 132


# --- the plain versions against the JAX kernels --------------------------------


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [96, 130])
def test_plain_versions_match_jax_vmap_at_wide_d(monkeypatch, variant, dtype, D):
    """K1's, K1b's and K1c's plain versions (and the CPU dispatch of
    `fused_mlp` under the variant) with a model axis of P = 3 at a wide D
    (130: a D that no stage divides), M = 1,100 (K1b's two whole chunks and
    a partial one), widths (M, 700, 0) a model, against `jax.vmap` of JAX's
    kernel of the same variant in interpret mode: f32 within 2e-5 + 1e-4
    rel, bf16 within 0.05 + 0.05 rel."""
    rng = np.random.default_rng(D)
    P, N, M = 3, 70, 1100
    widths = [M, 700, 0]
    bound = (6.0 / (D + M)) ** 0.5
    x = rng.normal(size=(P, N, D)).astype(np.float32)
    w1 = rng.uniform(-bound, bound, size=(P, D, M)).astype(np.float32)
    b1 = (rng.normal(size=(P, M)) * 0.1).astype(np.float32)
    w2 = rng.uniform(-bound, bound, size=(P, M, D)).astype(np.float32)
    b2 = (rng.normal(size=(P, D)) * 0.1).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    monkeypatch.setattr(pallas_mlp, "_MLP_VARIANT", variant)
    with pltpu.force_tpu_interpret_mode():
        ref = jax.vmap(pallas_mlp.fused_mlp)(
            *(jnp.asarray(a).astype(jdt) for a in (x, w1, b1, w2, b2)),
            jnp.asarray(widths, jnp.int32))
    ref = np.asarray(ref, np.float32)
    tdt = getattr(torch, dtype)
    args = (torch.from_numpy(x).to(tdt),
            torch.from_numpy(w1.transpose(0, 2, 1).copy()).to(tdt),
            torch.from_numpy(b1).to(tdt),
            torch.from_numpy(w2.transpose(0, 2, 1).copy()).to(tdt),
            torch.from_numpy(b2).to(tdt))
    wt = torch.tensor(widths, dtype=torch.int32)
    monkeypatch.setattr(fused_mlp, "_MLP_VARIANT", variant)
    for out in (PLAIN[variant](*args, wt), fused_mlp.fused_mlp(*args, wt)):
        assert out.dtype == tdt and out.shape == (P, N, D)
        np.testing.assert_allclose(out.float().numpy(), ref, **TOL[dtype])
    # a model of width 0 gives b2
    np.testing.assert_array_equal(out[2].float().numpy(),
                                  np.broadcast_to(args[4][2].float().numpy(), (N, D)))


# --- the stacked model against JAX's vmapped model ------------------------------

WIDE_TOY = dict(patch_size=(16, 16, 5), hidden_size=96, mlp_dim=384, num_heads=2,
                num_layers=2, dropout_rate=0.0, img_size=32, z_size=5)


@pytest.fixture(scope="module")
def wide_members():
    """Three members of the wide toy config from JAX's init (seeds 0-2),
    random heads and position embeddings, stacked on a leading axis in both
    frameworks' layouts; volumes; widths (384, 200, 0) and depths (2, 1, 2)."""
    cfg = JaxViTConfig(**WIDE_TOY)
    model = JaxVisionTransformer3D(cfg, zero_head=True, vis=False)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 32, 32, 5, 1)).astype(np.float32)
    init = jax.jit(lambda key: model.init(key, jnp.asarray(x), deterministic=True))
    members = []
    for seed in range(3):
        params = jax.device_get(init(jax.random.PRNGKey(seed))["params"])
        params["head"]["kernel"] = rng.uniform(
            -0.1, 0.1, size=params["head"]["kernel"].shape).astype(np.float32)
        pos = params["embeddings"]["position_embeddings"]
        params["embeddings"]["position_embeddings"] = (
            rng.normal(size=pos.shape) * 0.5).astype(np.float32)
        members.append(params)
    stacked = jax.tree.map(lambda *a: np.stack([np.asarray(v) for v in a]), *members)
    flat = [vit_state_from_flax(m, ViTConfig(**WIDE_TOY)) for m in members]
    state = {k: torch.stack([m[k] for m in flat]) for k in flat[0]}
    return {"model": model, "params": stacked, "state": state, "x": x,
            "widths": [384, 200, 0], "layers": [2, 1, 2]}


@pytest.mark.parametrize("variant", VARIANTS)
def test_stacked_model_at_wide_d_matches_jax(monkeypatch, wide_members, variant):
    """`stacked_forward` at D 96, M 384, 2 layers of 2 heads of 48, P = 3
    with per-model widths and depths, its MLP on the variant's kernel (on
    the CPU its plain version), against JAX's vmapped `model.apply` on its
    pallas MLP of the same variant in interpret mode, within 2e-4."""
    m = wide_members
    model = m["model"]

    def apply(p, n_layers, width):
        return model.apply({"params": p}, jnp.asarray(m["x"]), deterministic=True,
                           num_layers_active=n_layers, mlp_active=width).logits

    monkeypatch.setattr(pallas_mlp, "_MLP_VARIANT", variant)
    jax_mlp_select.set_default_mlp_impl("pallas")
    try:
        with pltpu.force_tpu_interpret_mode():
            ref = jax.vmap(apply)(m["params"], jnp.asarray(m["layers"], jnp.int32),
                                  jnp.asarray(m["widths"], jnp.int32))
    finally:
        jax_mlp_select.set_default_mlp_impl("xla")
    monkeypatch.setattr(fused_mlp, "_MLP_VARIANT", variant)
    mlp_select.set_default_mlp_impl("kernel")
    try:
        with torch.no_grad():
            out = stacked_forward(
                m["state"], ViTConfig(**WIDE_TOY), torch.from_numpy(m["x"])[None],
                layers_active=torch.tensor(m["layers"], dtype=torch.int32),
                mlp_active=torch.tensor(m["widths"], dtype=torch.int32))
    finally:
        mlp_select.set_default_mlp_impl("auto")
    assert out.shape == (3, 2, 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-4, rtol=0)


# --- the wide plans, pure Python --------------------------------------------------

PLAN_SHAPES = [(4104, 768, 3072), (513, 768, 3072), (513, 1280, 5120),
               (4104, 1280, 5120), (70, 96, 1100), (1, 8192, 2048), (600, 1288, 5152)]


@pytest.mark.parametrize("n,D,M", PLAN_SHAPES)
@pytest.mark.parametrize("chunked", [False, True])
def test_wide_f32_splits_do_not_depend_on_the_models(n, D, M, chunked):
    """The wide f32 plan's K splits and stages depend on (n, D, M) alone:
    1 to 30 stacked models split as one does, each model's units are one
    model's units, and every (model, tile) is covered once in each split.
    K1b's fc2 splits are its 512-column chunks, in order."""
    one = fused_mlp.wide_f32_plan(n, D, M, SMS, 1, chunked)
    for models in (1, 2, 5, 30):
        plan = fused_mlp.wide_f32_plan(n, D, M, SMS, models, chunked)
        for name in ("fc1", "fc2"):
            phase, alone = plan[name], one[name]
            assert (phase["splits"], phase["k_stages"], phase["tiles"]) == (
                alone["splits"], alone["k_stages"], alone["tiles"])
            assert phase["units"] == models * alone["units"]
            seen = set()
            for u in range(phase["units"]):
                p, row0, col0, k0, k1 = fused_mlp.wide_f32_unit(phase, u)
                assert (row0, col0, k0, k1) == fused_mlp.wide_f32_unit(
                    alone, u % alone["tiles"] + (u // (alone["tiles"] * models))
                    * alone["tiles"])[1:]
                assert (p, row0, col0, k0) not in seen
                seen.add((p, row0, col0, k0))
            assert len(seen) == phase["units"]
    fc2 = one["fc2"]
    if chunked:
        chunk = fused_mlp.WIDE_F32_CHUNK_STAGES
        assert fc2["splits"] == -(-M // fused_mlp._CHUNK_M)
        spans = [fused_mlp.wide_f32_unit(fc2, s * fc2["tiles"])[3:] for s in range(fc2["splits"])]
        assert spans == [(s * chunk, min((s + 1) * chunk, fc2["k_stages"]))
                         for s in range(fc2["splits"])]


@pytest.mark.parametrize("n,D,M", PLAN_SHAPES)
@pytest.mark.parametrize("models", [1, 2, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1c_queue_puts_each_fc2_unit_after_its_row_tiles_fc1(n, D, M, models, dtype):
    """K1c's wide queue: every (group, column tile) unit of both phases once,
    a ticket each; every fc2 unit after all fc1 units of its (model, row
    tile) group, so it waits only on smaller tickets; fc1 of group g + L
    ahead of fc2 of group g, L the plan's lead (the groups whose h fills
    half the L2, at least two waves of the grid, at most the groups); a grid
    of at most one block an SM.  Its fc2 tiles in
    bf16 are K1's (192 columns where one model's tiles fill the SMs), from
    (n, D) alone."""
    plan = fused_mlp.k1c_wide_plan(n, D, M, models, dtype, SMS)
    rows = -(-n // fused_mlp.WIDE_TILE_ROWS)
    a, b, lead = plan["fc1_units"], plan["fc2_units"], plan["lead"]
    assert plan["groups"] == models * rows
    assert plan["blocks"] <= plan["resident"] == SMS and plan["blocks"] <= plan["units"]
    assert plan["units"] == plan["groups"] * (a + b)
    elt = 2 if dtype == torch.bfloat16 else 4
    h_group = 128 * -(-M * elt // 16) * 16     # 128 rows of h, 16-byte rows
    assert lead == min(plan["groups"], max(-(-2 * plan["blocks"] // (a + b)),
                                           fused_mlp.WIDE_L2_BYTES // 2 // h_group)) >= 1
    queue = [fused_mlp.k1c_wide_unit(plan, u) for u in range(plan["units"])]
    assert sorted(queue) == sorted([("fc1", g, t) for g in range(plan["groups"]) for t in range(a)]
                                   + [("fc2", g, t) for g in range(plan["groups"]) for t in range(b)])
    first_fc1, last_fc1, first_fc2 = {}, {}, {}
    for u, (phase, g, _) in enumerate(queue):
        if phase == "fc1":
            first_fc1.setdefault(g, u)
            last_fc1[g] = u
        else:
            first_fc2.setdefault(g, u)
            assert last_fc1[g] < u
    for g in range(plan["groups"] - lead):
        assert last_fc1[g + lead] < first_fc2[g]
        if g + lead + 1 < plan["groups"]:
            assert first_fc2[g] < first_fc1[g + lead + 1]
    if dtype == torch.bfloat16:
        assert plan["fc1_cols"] == 128
        assert plan["fc2_cols"] == (192 if rows * -(-D // 192) >= SMS else 64)
        assert plan["fc2_cols"] == fused_mlp.k1c_wide_plan(n, D, M, 1, dtype, SMS)["fc2_cols"]
    else:
        assert plan["fc1_cols"] == plan["fc2_cols"] == 64


def queue_makespan(plan: dict, dtype, grid: int = 0) -> float:
    """A model of K1c's persistent grid of `grid` blocks (the plan's by
    default), of which the card holds `plan["resident"]` at once: a running
    block takes the next ticket when it frees (ties to the lower block),
    each unit taking its K stages (an fc2 unit in bf16 its tile's width over
    fc1's too), and an fc2 unit starts once its group's fc1 units have ended.
    A block that draws a ticket past the queue ends, and a block not yet
    resident takes its place (and ends too: the queue is done).  Returns the
    last end over the ideal (all the work spread evenly over the running
    blocks)."""
    a, b, groups = plan["fc1_units"], plan["fc2_units"], plan["groups"]
    stage = 64 if dtype == torch.bfloat16 else 32
    t1 = -(-plan["D"] // stage)
    t2 = -(-plan["M"] // stage) * plan["fc2_cols"] / plan["fc1_cols"]
    running = min(grid or plan["blocks"], plan["resident"])
    free = [(0.0, blk) for blk in range(running)]
    fc1_end = [0.0] * groups
    end = 0.0
    for u in range(plan["units"]):
        at, blk = heapq.heappop(free)
        phase, g, _ = fused_mlp.k1c_wide_unit(plan, u)
        start = at if phase == "fc1" else max(at, fc1_end[g])
        done = start + (t1 if phase == "fc1" else t2)
        if phase == "fc1":
            fc1_end[g] = max(fc1_end[g], done)
        heapq.heappush(free, (done, blk))
        end = max(end, done)
    ideal = groups * (a * t1 + b * t2) / running
    return end / ideal


@pytest.mark.parametrize("n,D,M,models,dtype,grid", [
    (4104, 768, 3072, 5, torch.bfloat16, 0), (513, 768, 3072, 5, torch.float32, 0),
    (4104, 768, 3072, 1, torch.float32, 0), (513, 1280, 5120, 2, torch.bfloat16, 0),
    (4104, 1280, 5120, 2, torch.bfloat16, 0), (4104, 768, 3072, 5, torch.float32, 2 * SMS)])
def test_k1c_queue_runs_to_its_end_on_a_persistent_grid(n, D, M, models, dtype, grid):
    """On the model of the persistent grid (`queue_makespan`) every ticket
    ends: no block waits on a unit that no block reaches, also on a grid of
    twice the blocks the card holds at once, which tickets allow (a block
    that is not resident has taken none).  The plan's lead with tickets
    keeps the grid within 1.2 times the ideal at the stretch and ViT-H-width
    cases (a lead of one row tile on a static round robin took 1.65-3.27
    times there)."""
    plan = fused_mlp.k1c_wide_plan(n, D, M, models, dtype, SMS)
    ratio = queue_makespan(plan, dtype, grid)
    assert 1.0 <= ratio <= 1.2


# --- the width stays on the device -----------------------------------------------


def test_active_arg_keeps_a_tensor_width_on_the_device(monkeypatch):
    """A tensor width is never read on the host: `_active_arg` hands the
    bodies an int32 tensor of one width a model on the call's device at
    every D (it no longer takes the body), and a plain int stays an int."""
    for name in ("__int__", "__index__", "item", "tolist", "__bool__"):
        monkeypatch.setattr(torch.Tensor, name, lambda *a, **k: pytest.fail(
            "a tensor width was read on the host"))
    device = torch.device("cpu")
    for widths in (torch.tensor([3072, 2048, 1000], dtype=torch.int64),
                   torch.tensor(3000, dtype=torch.int32)):
        active, per_model = fused_mlp._active_arg(widths, 3, 3072, device)
        assert active == 0
        assert per_model.dtype == torch.int32 and per_model.device == device
        assert per_model.shape == (3,) and per_model.is_contiguous()
    monkeypatch.undo()
    assert fused_mlp._active_arg(5000, 3, 3072, device) == (3072, None)
    assert fused_mlp._active_arg(-4, 1, 3072, device) == (0, None)
    with pytest.raises(ValueError, match="2 entries for 3 models"):
        fused_mlp._active_arg(torch.tensor([1, 2]), 3, 3072, device)
