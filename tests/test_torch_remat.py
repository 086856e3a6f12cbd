"""Remat in the port (`ops/attention.checkpoint_block`): each encoder block's
activations recomputed in the backward pass, its dropout stream replayed.

With dropout on, remat must give what the run without it gives, bit for
bit on the CPU: the gradients of a stacked model under the cells' streams
(`CellDropout`) and of a model and an ensemble under a `torch.Generator`,
with the streams left where the forward left them; `run_group` with
`SweepHyper.remat`; and the padded grid, which always trains under remat,
against the same grid with remat taken out.  With dropout 0, `run_group`
under remat matches JAX's `remat=True` run at `test_run_group_matches_jax`'s
tolerances.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from vit3d_ensemble_tpu.sweep import engine as jax_engine
from vit3d_ensemble_tpu.sweep import stack as jax_stack
from vit3d_ensemble_tpu_torch.configs import ViTConfig
from vit3d_ensemble_tpu_torch.models import TransformerEnsemble, VisionTransformer3D
from vit3d_ensemble_tpu_torch.ops.attention import CellDropout
from vit3d_ensemble_tpu_torch.sweep import e2e_grid, engine, stack
from vit3d_ensemble_tpu_torch.sweep.stacked import stacked_forward

from test_e2e_grid import EPOCHS, SEED
from test_torch_e2e_grid import _grid, bank  # noqa: F401  (a fixture)
from test_torch_sweep import IMG, _fold_data, _jax_group, _stacked_state, tiny  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _equal_grads(a, b):
    assert list(a) == list(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_stacked_gradients_equal_under_remat(tiny):
    """Two steps of a stacked model of 2 configs x 2 folds at dropout 0.1,
    the cells' streams drawing: logits and gradients equal with and without
    remat, and each stream's site counter where the forwards left it."""
    group = tiny
    config = group.template_config(IMG)
    x = torch.randn(2, 2, IMG, IMG, 5, 1, generator=torch.Generator().manual_seed(1))
    layers = torch.tensor([2, 2, 3, 3])
    widths = torch.tensor([32, 32, 48, 48])

    def run(remat):
        params = {k: v.reshape(4, *v.shape[2:]).clone().requires_grad_()
                  for k, v in stack.init_group_params(group, 2, 0, IMG).items()}
        cells = CellDropout(3, [0, 1, 2, 3], "cpu")
        logits = []
        for _ in range(2):
            out = stacked_forward(params, config, x, layers_active=layers,
                                  mlp_active=widths, deterministic=False,
                                  generator=cells, remat=remat)
            out.pow(2).sum().backward()
            logits.append(out.detach())
        return logits, {k: v.grad for k, v in params.items()}, cells.site

    (l0, g0, s0), (l1, g1, s1) = run(False), run(True)
    assert s0 == s1 > 0
    assert all(torch.equal(a, b) for a, b in zip(l0, l1))
    _equal_grads(g0, g1)


@pytest.mark.parametrize("kind", ["model", "ensemble"])
def test_model_gradients_equal_under_remat(kind):
    """conf 9 (and the {5, 9} ensemble) at 32 px, dropout on from a
    `torch.Generator`: outputs and every gradient equal with and without
    remat, and the generator in the same state after the backward."""
    cfgs = [ViTConfig.from_conf(c, img_size=IMG) for c in ((9,) if kind == "model"
                                                           else (5, 9))]
    x = torch.randn(2, IMG, IMG, 5, 1, generator=torch.Generator().manual_seed(1))

    def run(remat):
        gen = torch.Generator().manual_seed(5)
        if kind == "model":
            model = VisionTransformer3D(cfgs[0], device="cpu", vis=False, zero_head=False,
                                        remat=remat)
            out = model(x, deterministic=False, generator=gen).logits
        else:
            model = TransformerEnsemble(cfgs, device="cpu", zero_head=False, remat=remat)
            out = model(x, deterministic=False, generator=gen)
        out.pow(2).sum().backward()
        return out.detach(), {k: p.grad for k, p in model.named_parameters()}, gen.get_state()

    (o0, g0, s0), (o1, g1, s1) = run(False), run(True)
    assert torch.equal(o0, o1) and torch.equal(s0, s1)
    _equal_grads(g0, g1)


def test_run_group_remat_equals_no_remat(tiny):
    """`run_group` at dropout 0.1 with `SweepHyper.remat` on and off: every
    step's losses, the best metrics and parameters equal."""
    pool, folds = _fold_data(5)
    hyper = engine.SweepHyper(num_steps=4, eval_every=2, train_batch_size=2,
                              learning_rate=0.05, warmup_steps=2, seed=0)
    data = engine.stack_folds(pool, folds, hyper)
    off = engine.run_group(tiny, data, hyper, img_size=IMG, device="cpu")
    on = engine.run_group(tiny, data, dataclasses.replace(hyper, remat=True),
                          img_size=IMG, device="cpu")
    np.testing.assert_array_equal(on.losses, off.losses)
    np.testing.assert_array_equal(on.best_metrics, off.best_metrics)
    for k, v in off.best_params.items():
        assert torch.equal(on.best_params[k], v), k


def test_grid_remat_equals_no_remat(bank, monkeypatch):
    """The grid trains under remat; with dropout on, its metrics equal the
    same grid's with remat taken out of its forwards."""
    _, _, cfgs, members, folds = bank
    cfgs = {c: dataclasses.replace(cfg, dropout_rate=0.1) for c, cfg in cfgs.items()}
    data = e2e_grid.stack_e2e_folds(folds, EPOCHS, 4, SEED)
    combos = [(1, 2), (2, 4)]
    on = _grid(cfgs, members, data, combos=combos)
    real = e2e_grid.stacked_forward
    remats = []

    def without_remat(*a, remat=False, **k):
        remats.append(remat)
        return real(*a, remat=False, **k)

    monkeypatch.setattr(e2e_grid, "stacked_forward", without_remat)
    off = _grid(cfgs, members, data, combos=combos)
    assert any(remats)
    assert on == off


def test_run_group_remat_matches_jax(tiny, monkeypatch):
    """Dropout 0, both under remat (JAX's `SweepHyper.remat`, `nn.remat` of
    each block), from JAX's init: the tolerances of
    `tests/test_torch_sweep.py::test_run_group_matches_jax`."""
    real = jax_stack.ConfigGroup.template_config
    monkeypatch.setattr(jax_stack.ConfigGroup, "template_config",
                        lambda self, img_size=128: dataclasses.replace(
                            real(self, img_size), dropout_rate=0.0))
    group = dataclasses.replace(tiny, dropout_rate=0.0)
    pool, folds = _fold_data(5)
    hyper = engine.SweepHyper(num_steps=4, eval_every=2, train_batch_size=2,
                              learning_rate=0.05, warmup_steps=2, seed=0, remat=True)
    jhyper = jax_engine.SweepHyper(**dataclasses.asdict(hyper))
    template = group.template_config(IMG)
    params0 = jax_stack.init_group_params(_jax_group(group), 2, 0, IMG)
    monkeypatch.setattr(jax_engine, "init_group_params", lambda *a, **k: params0)
    state0 = _stacked_state(jax.device_get(params0), template, (2, 2))
    monkeypatch.setattr(engine, "init_group_params",
                        lambda *a, **k: {k_: v.clone() for k_, v in state0.items()})
    ref = jax_engine.run_group(_jax_group(group),
                               jax_engine.stack_folds(pool, folds, jhyper), jhyper,
                               img_size=IMG)
    out = engine.run_group(group, engine.stack_folds(pool, folds, hyper), hyper,
                           img_size=IMG, device="cpu")
    np.testing.assert_allclose(out.final_loss, np.asarray(ref.final_loss), atol=1e-5)
    np.testing.assert_allclose(out.best_metrics, np.asarray(ref.best_metrics), atol=1e-6)
    np.testing.assert_allclose(out.best_probs, np.asarray(ref.best_probs), atol=1e-5)
    best = _stacked_state(jax.device_get(ref.best_params), template, (2, 2))
    for k, v in best.items():
        np.testing.assert_allclose(out.best_params[k].detach().numpy(), v.numpy(),
                                   atol=1e-4, rtol=0, err_msg=k)
