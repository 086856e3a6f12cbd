"""The port's training slice against the JAX package's, on the CPU.

Data, batching, metrics, schedules, optimizers and selection are compared
piece by piece; then both trainers are run in both frameworks from the same
weights with dropout off, step for step.  The JAX trainers compile a whole
run and return its last loss and its best evaluation; the per-step losses
and final parameters come from a JAX loop of the trainer's own step
(`trainer.py:139-153`, `ensemble_trainer.py:119-134`), itself held to the
JAX trainer's last loss and best parameters.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from vit3d_ensemble_tpu.checkpoint import torch_ensemble_to_flax
from vit3d_ensemble_tpu.configs import ViTConfig as JaxViTConfig
from vit3d_ensemble_tpu.data import EpochBatcher as JaxEpochBatcher
from vit3d_ensemble_tpu.data import SplitArrays as JaxSplitArrays
from vit3d_ensemble_tpu.metrics.jax_metrics import (
    compute_eval_metrics as jax_compute_eval_metrics,
)
from vit3d_ensemble_tpu.models import (
    TransformerEnsemble as JaxTransformerEnsemble,
    VisionTransformer3D as JaxVisionTransformer3D,
)
from vit3d_ensemble_tpu.sweep.engine import METRIC_KEYS as JAX_METRIC_KEYS
from vit3d_ensemble_tpu.sweep.engine import _metrics_vector as jax_metrics_vector
from vit3d_ensemble_tpu.train import ensemble_trainer as jax_ensemble_trainer
from vit3d_ensemble_tpu.train import trainer as jax_trainer
from vit3d_ensemble_tpu.train.optim import adam as jax_adam
from vit3d_ensemble_tpu.train.optim import sgd_momentum as jax_sgd_momentum
from vit3d_ensemble_tpu.train.schedules import make_schedule as jax_make_schedule
from vit3d_ensemble_tpu.train.selection import BestTracker as JaxBestTracker
from vit3d_ensemble_tpu.train.steps import (
    masked_balanced_pos_weight as jax_pos_weight,
    masked_bce_with_logits as jax_bce_with_logits,
)
from vit3d_ensemble_tpu_torch.checkpoint import (
    ensemble_state_from_flax,
    vit_state_from_flax,
)
from vit3d_ensemble_tpu_torch.configs import ViTConfig
from vit3d_ensemble_tpu_torch.data import EpochBatcher, SplitArrays
from vit3d_ensemble_tpu_torch.metrics import (
    METRIC_KEYS,
    compute_eval_metrics,
    metrics_vector,
)
from vit3d_ensemble_tpu_torch.models import VisionTransformer3D
from vit3d_ensemble_tpu_torch.train import ensemble_trainer, trainer
from vit3d_ensemble_tpu_torch.train.losses import masked_bce_on_probs
from vit3d_ensemble_tpu_torch.train.optim import adam, sgd_momentum
from vit3d_ensemble_tpu_torch.train.schedules import make_factor
from vit3d_ensemble_tpu_torch.train.selection import (
    BestTracker,
    device_best_init,
    device_consider,
    device_take_if,
)
from vit3d_ensemble_tpu_torch.train.steps import (
    masked_balanced_pos_weight,
    masked_bce_with_logits,
)
from vit3d_ensemble_tpu_torch.utils.metrics_log import MetricsLogger

IMG = 32


# --- data -------------------------------------------------------------------


@pytest.mark.parametrize("n,batch,seed", [(10, 4, 0), (24, 4, 42), (7, 3, 5)])
def test_epoch_batcher_matches_jax(n, batch, seed):
    ours = EpochBatcher(n, batch, seed=seed)
    ref = JaxEpochBatcher(n, batch, seed=seed)
    assert ours.steps_per_epoch == ref.steps_per_epoch
    for (i, m), (ri, rm) in zip(ours.batches(11), ref.batches(11)):
        np.testing.assert_array_equal(i, ri)
        np.testing.assert_array_equal(m, rm)
    unshuffled = EpochBatcher(n, batch, seed=seed, shuffle=False)
    first, mask = next(unshuffled.epoch())
    np.testing.assert_array_equal(first, np.arange(batch))
    assert mask.sum() == batch


def _split(n, seed, shift=0.8, cls=SplitArrays):
    """Balanced synthetic volumes, the positives shifted by `shift`."""
    rng = np.random.default_rng(seed)
    y = np.tile([0, 1], n // 2).astype(np.int32)
    x = rng.normal(size=(n, IMG, IMG, 5, 1)).astype(np.float32)
    x[y == 1] += shift
    return cls(x, y, [f"p{i}" for i in range(n)], ["PZ"] * n)


def test_split_arrays_matches_jax():
    ours, ref = _split(6, 0), _split(6, 0, cls=JaxSplitArrays)
    for a, b in ((ours.subset([4, 1]), ref.subset([4, 1])),
                 (SplitArrays.concat([ours, ours.subset([2])]),
                  JaxSplitArrays.concat([ref, ref.subset([2])]))):
        np.testing.assert_array_equal(a.volumes, b.volumes)
        np.testing.assert_array_equal(a.labels, b.labels)
        assert (a.patients, a.zones, len(a)) == (b.patients, b.zones, len(b))


# --- metrics ----------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
def test_metrics_match_jax(masked):
    """Quantised probabilities force ties.  Measured max abs deviation 6e-8
    over 20 draws (tolerance 1e-6)."""
    rng = np.random.default_rng(7 + masked)
    assert METRIC_KEYS == JAX_METRIC_KEYS
    # jitted, as the JAX trainers run it
    jax_suite = jax.jit(lambda p, y, m: jax_metrics_vector(
        jax_compute_eval_metrics(p, y, m)))
    for trial in range(20):
        n = (9, 22)[trial % 2]        # two shapes: two compilations
        y = rng.integers(0, 2, n)
        y[:2] = [0, 1]
        p = np.round(rng.random(n), 1).astype(np.float32)
        mask = (rng.random(n) > 0.3).astype(np.float32) if masked else None
        if masked:
            mask[:2] = 1.0
        ref = jax_suite(jnp.asarray(p), jnp.asarray(y),
                        None if mask is None else jnp.asarray(mask))
        out = metrics_vector(compute_eval_metrics(
            torch.from_numpy(p), torch.from_numpy(y),
            None if mask is None else torch.from_numpy(mask)))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6,
                                   err_msg=f"trial {trial}")


# --- losses, schedules, optimizers, selection --------------------------------


def test_losses_match_jax():
    """Measured max abs deviation 6e-8 (tolerance 1e-6)."""
    rng = np.random.default_rng(8)
    for mask in ([1, 1, 1, 1], [1, 1, 0, 0], [1, 1, 1, 0], [0, 0, 0, 0]):
        logits = rng.normal(size=4).astype(np.float32) * 3
        labels = np.array([1, 0, 1, 1], np.float32)
        m = np.array(mask, np.float32)
        pw = jax_pos_weight(jnp.asarray(labels), jnp.asarray(m))
        ref = jax_bce_with_logits(jnp.asarray(logits), jnp.asarray(labels),
                                  jnp.asarray(m), pw)
        t = lambda a: torch.from_numpy(a)  # noqa: E731
        opw = masked_balanced_pos_weight(t(labels), t(m))
        out = masked_bce_with_logits(t(logits), t(labels), t(m), opw)
        np.testing.assert_allclose(float(opw), float(pw), rtol=1e-6)
        np.testing.assert_allclose(float(out), float(ref), atol=1e-6)
        # the ensemble's objective, `ensemble_trainer.py:123-125`
        probs = 1 / (1 + np.exp(-logits))
        pc = jnp.clip(jnp.asarray(probs), 1e-12, 1 - 1e-12)
        per = -(labels * jnp.log(pc) + (1 - labels) * jnp.log(1 - pc))
        ref = jnp.sum(per * m) / jnp.maximum(jnp.sum(m), 1.0)
        out = masked_bce_on_probs(t(probs), t(labels), t(m))
        np.testing.assert_allclose(float(out), float(ref), atol=1e-6)


@pytest.mark.parametrize("shift", [0, 1])
@pytest.mark.parametrize("decay_type,warmup,total", [
    ("cosine", 10, 100), ("cosine", 1000, 100), ("linear", 10, 100),
    ("warmup_constant", 4, 10), ("constant", 0, 10)])
def test_schedules_match_jax(decay_type, warmup, total, shift):
    """The factor at every step against the optax schedule over the base
    lr, which computes in f32: measured max abs deviation 1.2e-8 (tolerance
    1e-6, about 8 f32 ulps of 1)."""
    lr = 3e-4
    ref = jax_make_schedule(decay_type, lr, warmup, total, shift=shift)
    factor = make_factor(decay_type, warmup, total, shift=shift)
    for step in range(total + 20):
        np.testing.assert_allclose(factor(step), float(ref(jnp.asarray(step))) / lr,
                                   rtol=0, atol=1e-6, err_msg=f"step={step}")


def test_optimizers_match_jax_step_exact():
    """SGD + LambdaLR and Adam against the JAX chains over 8 updates,
    including the warmup's zero-LR first update.  Measured max abs
    deviation 6e-8 (tolerance 1e-6)."""
    rng = np.random.default_rng(9)
    w0 = rng.normal(size=5).astype(np.float32)
    grads = rng.normal(size=(8, 5)).astype(np.float32)
    for ours_fn, ref_tx in (
            (lambda p: sgd_momentum(p, 0.1, make_factor("cosine", 3, 8),
                                    weight_decay=0.01),
             jax_sgd_momentum(jax_make_schedule("cosine", 0.1, 3, 8),
                              weight_decay=0.01)),
            (lambda p: (adam(p, 1e-2), None), jax_adam(1e-2))):
        tw = torch.nn.Parameter(torch.from_numpy(w0.copy()))
        opt, sched = ours_fn([tw])
        params, state = jnp.asarray(w0), ref_tx.init(jnp.asarray(w0))
        for g in grads:
            tw.grad = torch.from_numpy(g.copy())
            opt.step()
            if sched is not None:
                sched.step()
            upd, state = ref_tx.update(jnp.asarray(g), state, params)
            params = optax.apply_updates(params, upd)
            np.testing.assert_allclose(tw.detach().numpy(), np.asarray(params),
                                       atol=1e-6, rtol=1e-6)


def test_device_selection_follows_the_tracker():
    """The tensor form accepts exactly where the host tracker (the JAX
    package's) does, and the forced final take fills in only when nothing
    was accepted."""
    rng = np.random.default_rng(10)
    for trial in range(10):
        host, ours = JaxBestTracker(), BestTracker()
        payload = {"w": torch.zeros(3)}
        best = device_best_init(11, 4, payload)
        for e in range(6):
            mvec = torch.from_numpy(rng.random(11).astype(np.float32))
            spec, sens, auc = (float(mvec[i]) for i in (0, 1, 3))
            metrics = {"AUROC": auc}
            took = host.consider(spec, sens, auc, metrics, payload=e)
            assert ours.consider(spec, sens, auc, metrics, payload=e) == took
            best = device_consider(best, mvec, torch.full((4,), float(e)),
                                   {"w": torch.full((3,), float(e))}, False)
            assert bool(best["choice"]) == host.best_choice
            if host.payload is not None:
                assert float(best["probs"][0]) == host.payload
                assert float(best["payload"]["w"][0]) == host.payload
                np.testing.assert_allclose(float(best["auc"]), host.best_auc)
        assert bool(best["found"]) == (host.payload is not None)
        final = device_take_if(best, torch.ones(11), torch.full((4,), 9.0),
                               {"w": torch.full((3,), 9.0)}, ~best["found"])
        expect = 9.0 if host.payload is None else float(host.payload)
        assert float(final["payload"]["w"][0]) == expect
        assert bool(final["found"])


# --- the trainers, step for step ----------------------------------------------


def _cfgs(**kw):
    return JaxViTConfig(**kw), ViTConfig(**kw)


def _jax_steps(loss_fn, params, tx, batches):
    """The JAX trainers' micro-step (value_and_grad, tx.update,
    apply_updates) as a host loop: per-step losses and final params."""
    @jax.jit
    def step(p, opt, idx, bm):
        loss, grads = jax.value_and_grad(loss_fn)(p, idx, bm)
        upd, opt = tx.update(grads, opt, p)
        return optax.apply_updates(p, upd), opt, loss

    opt, losses = tx.init(params), []
    for idx, bm in batches:
        params, opt, loss = step(params, opt, jnp.asarray(idx),
                                 jnp.asarray(bm))
        losses.append(float(loss))
    return np.asarray(losses), params


def _close_state(ours, ref, atol, what, noise_atol=None):
    """Every tensor within `atol`, except the attention key biases under
    `noise_atol`: their gradient is zero in exact arithmetic (a softmax is
    blind to a shift of every score), so both frameworks' f32 gradients
    there are rounding noise, which Adam scales to lr-sized steps."""
    assert set(ours) == set(ref), what
    for k in ref:
        tol = (noise_atol if noise_atol is not None
               and k.endswith("attn.key.bias") else atol)
        np.testing.assert_allclose(ours[k].detach().numpy(), ref[k].numpy(),
                                   atol=tol, rtol=0, err_msg=f"{what}: {k}")


_BASELINE = {}


def _baseline_setup():
    """The conf-9-class model (D=16, H=16, hd 1) cut to 2 layers of 64
    columns at 32 px, dropout off, with its JAX init (built once)."""
    if not _BASELINE:
        kw = dict(patch_size=(16, 16, 5), hidden_size=16, num_heads=16,
                  mlp_dim=64, num_layers=2, img_size=IMG, dropout_rate=0.0)
        jcfg, cfg = _cfgs(**kw)
        _BASELINE.update(jcfg=jcfg, cfg=cfg, params0=jax.device_get(
            jax_trainer.init_baseline(jcfg, 3)[1]))
    return _BASELINE


@pytest.mark.parametrize("accum", [1, 2])
def test_train_baseline_matches_jax(monkeypatch, tmp_path, accum):
    """SGD from the JAX init, converted into the port's model by patching
    its `init_baseline`.  Measured: losses within 6e-8, final and best
    parameters within 5e-8, metrics equal to 3e-8 (tolerances 1e-5, 1e-4,
    1e-5)."""
    b = _baseline_setup()
    jcfg, cfg, params0 = b["jcfg"], b["cfg"], b["params0"]
    # the JAX trainer's own init gives params0 for this seed; reuse it
    # rather than compile it again
    monkeypatch.setattr(jax_trainer, "init_baseline", lambda c, seed: (
        JaxVisionTransformer3D(c, zero_head=True, vis=False), params0))
    train, val = _split(12, 11), _split(8, 12)
    jtrain = JaxSplitArrays(train.volumes, train.labels, train.patients,
                            train.zones)
    jval = JaxSplitArrays(val.volumes, val.labels, val.patients, val.zones)
    hyper = dict(num_steps=6, eval_every=3, train_batch_size=4,
                 learning_rate=1e-2, warmup_steps=2, seed=3,
                 gradient_accumulation_steps=accum)
    ref = jax_trainer.train_baseline(jcfg, jtrain, jval, **hyper)

    models = []

    def init_from_jax(config, seed, zero_head=True, device=None):
        model = VisionTransformer3D(config, vis=False, device=device)
        model.load_state_dict(vit_state_from_flax(params0, config))
        models.append(model)
        return model

    monkeypatch.setattr(trainer, "init_baseline", init_from_jax)
    log = tmp_path / "metrics.jsonl"
    save = tmp_path / "best.pt"
    out = trainer.train_baseline(cfg, train, val, device="cpu",
                                 save_path=str(save),
                                 metrics_logger=MetricsLogger(str(log)),
                                 **hyper)

    # the JAX step loop, checked against the JAX trainer's last loss
    jmodel = JaxVisionTransformer3D(jcfg, zero_head=True, vis=False)
    vols = jnp.asarray(train.volumes)
    labels = jnp.asarray(train.labels.astype(np.float32))

    def loss_fn(p, idx, bm):
        logits = jmodel.apply({"params": p}, vols[idx], deterministic=False,
                              rngs={"dropout": jax.random.key(0)}).logits
        return jax_bce_with_logits(logits, labels[idx], bm,
                                   jax_pos_weight(labels[idx], bm))

    tx = jax_sgd_momentum(jax_make_schedule("cosine", 1e-2, 2, 6),
                          momentum=0.9, weight_decay=1e-2)
    if accum > 1:
        tx = optax.MultiSteps(tx, every_k_schedule=accum)
    losses, final = _jax_steps(
        loss_fn, params0, tx,
        JaxEpochBatcher(len(train), 4, seed=3).batches(6 * accum))
    np.testing.assert_allclose(losses[-1], ref.final_loss, atol=1e-6)

    assert len(out.losses) == 6 * accum
    np.testing.assert_allclose(out.losses, losses, atol=1e-5)
    assert out.final_loss == out.losses[-1]
    _close_state(models[0].state_dict(), vit_state_from_flax(final, cfg),
                 1e-4, "final")
    _close_state(out.best_params, vit_state_from_flax(ref.best_params, cfg),
                 1e-4, "best")
    for k in JAX_METRIC_KEYS:
        np.testing.assert_allclose(out.metrics[k], ref.metrics[k], atol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(out.class_probabilities,
                               ref.class_probabilities, atol=1e-5)
    np.testing.assert_array_equal(out.predicted_labels, ref.predicted_labels)
    np.testing.assert_array_equal(out.true_labels, val.labels)
    np.testing.assert_allclose(out.num_params_m, ref.num_params_m)
    saved = torch.load(save)
    _close_state(saved, out.best_params, 0, "saved")
    assert "transformer.encoder.layer.0.attn.query.weight" in saved
    assert '"event": "best_eval"' in log.read_text()


def test_train_ensemble_matches_jax(monkeypatch):
    """{5, 9, 11} narrowed to 32 columns and 1, 1, 2 layers at 32 px, the
    (D, H) of each kept, dropout off, Adam over every parameter, 2 epochs.
    Both start from the port's seeded `init_ensemble`, which the JAX
    package's own converter (`torch_ensemble_to_flax`) carries into the
    JAX trainer through its `init_ensemble` (a JAX init would compile once
    per member).  Measured: losses within 1.2e-7, final and best parameters
    within 1.1e-6, metrics equal to 4e-8 (tolerances 1e-5, 1e-4, 1e-5)."""
    pairs = [_cfgs(**dict(dataclasses.asdict(ViTConfig.from_conf(c, img_size=IMG)),
                          mlp_dim=32, num_layers=L, dropout_rate=0.0))
             for c, L in ((5, 1), (9, 1), (11, 2))]
    jcfgs, cfgs = [p[0] for p in pairs], [p[1] for p in pairs]
    train, val = _split(12, 13), _split(8, 14)
    jtrain = JaxSplitArrays(train.volumes, train.labels, train.patients,
                            train.zones)
    jval = JaxSplitArrays(val.volumes, val.labels, val.patients, val.zones)
    members = [trainer.init_baseline(c, seed=i, device="cpu").state_dict()
               for i, c in enumerate(cfgs)]
    state0 = ensemble_trainer.init_ensemble(cfgs, members, 0,
                                            device="cpu").state_dict()
    params0 = torch_ensemble_to_flax(
        {k: v.numpy() for k, v in state0.items()}, jcfgs)
    jmodel = JaxTransformerEnsemble(tuple(jcfgs))
    monkeypatch.setattr(jax_ensemble_trainer, "init_ensemble",
                        lambda configs, member_params, seed: (jmodel, params0))
    hyper = dict(num_epochs=2, train_batch_size=4, learning_rate=5e-3, seed=0)
    ref = jax_ensemble_trainer.train_ensemble(
        jcfgs, [params0[f"transformer_{i}"] for i in range(3)], jtrain, jval,
        **hyper)

    models = []
    real_init = ensemble_trainer.init_ensemble

    def init_and_keep(*args, **kwargs):
        models.append(real_init(*args, **kwargs))
        return models[-1]

    monkeypatch.setattr(ensemble_trainer, "init_ensemble", init_and_keep)
    out = ensemble_trainer.train_ensemble(cfgs, members, train, val,
                                          device="cpu", **hyper)

    vols = jnp.asarray(train.volumes)
    labels = jnp.asarray(train.labels.astype(np.float32))

    def loss_fn(p, idx, bm):
        probs = jmodel.apply({"params": p}, vols[idx], deterministic=False,
                             rngs={"dropout": jax.random.key(0)}).reshape(-1)
        pc = jnp.clip(probs, 1e-12, 1 - 1e-12)
        per = -(labels[idx] * jnp.log(pc) + (1 - labels[idx]) * jnp.log(1 - pc))
        return jnp.sum(per * bm) / jnp.maximum(jnp.sum(bm), 1.0)

    batcher = JaxEpochBatcher(len(train), 4, seed=0)
    batches = [b for _ in range(2) for b in batcher.epoch()]
    losses, final = _jax_steps(loss_fn, params0, jax_adam(5e-3), batches)

    np.testing.assert_allclose(out.losses, losses, atol=1e-5)
    # Adam moves a parameter at most about lr a step
    noise = 5e-3 * len(losses)
    _close_state(models[0].state_dict(),
                 ensemble_state_from_flax(final, cfgs), 1e-4, "final", noise)
    _close_state(out.best_params,
                 ensemble_state_from_flax(ref.best_params, cfgs), 1e-4, "best",
                 noise)
    for k in JAX_METRIC_KEYS:
        np.testing.assert_allclose(out.metrics[k], ref.metrics[k], atol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(out.class_probabilities,
                               ref.class_probabilities, atol=1e-5)


def test_padded_members_match_exact_shapes():
    """Members padded to their class templates with runtime masks give the
    exact-shape ensemble's forward and training run (dropout off), the
    padding is what the JAX package pads, and cropping restores the exact
    shapes.  Measured: forward 0, losses within 3e-8 (tolerances 1e-6,
    1e-5)."""
    cfgs = [ViTConfig(patch_size=(16, 16, 5), hidden_size=16, num_heads=4,
                      mlp_dim=m, num_layers=L, img_size=IMG, dropout_rate=0.0)
            for m, L in ((32, 2), (48, 3))]
    members = [trainer.init_baseline(c, seed=i, device="cpu").state_dict()
               for i, c in enumerate(cfgs)]
    t_cfgs, padded, masks = ensemble_trainer.pad_members_to_templates(
        cfgs, members, max_mlp=48, max_layers=3)
    assert masks == ((2, 32), (3, 48))
    assert (t_cfgs[0].mlp_dim, t_cfgs[0].num_layers) == (48, 3)
    fc1 = padded[0]["transformer.encoder.layer.1.ffn.fc1.weight"]
    assert fc1.shape == (48, 16) and torch.all(fc1[32:] == 0)
    assert torch.all(padded[0]["transformer.encoder.layer.2.ffn_norm.weight"] == 0)

    exact = ensemble_trainer.init_ensemble(cfgs, members, 0, device="cpu")
    pad = ensemble_trainer.init_ensemble(t_cfgs, padded, 0, device="cpu")
    x = torch.from_numpy(_split(4, 15).volumes)
    with torch.no_grad():
        torch.testing.assert_close(pad(x, member_masks=masks), exact(x),
                                   atol=1e-6, rtol=0)

    train, val = _split(8, 16), _split(4, 17)
    kw = dict(num_epochs=2, learning_rate=5e-3, seed=0, device="cpu")
    res_exact = ensemble_trainer.train_ensemble(cfgs, members, train, val, **kw)
    res_pad = ensemble_trainer.train_ensemble(t_cfgs, padded, train, val,
                                              member_masks=masks,
                                              crop_to=cfgs, **kw)
    np.testing.assert_allclose(res_pad.losses, res_exact.losses, atol=1e-5)
    assert ({k: v.shape for k, v in res_pad.best_params.items()}
            == {k: v.shape for k, v in res_exact.best_params.items()})


def test_trainers_need_a_card_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ViTConfig(patch_size=(16, 16, 5), hidden_size=16, num_heads=4,
                    mlp_dim=32, num_layers=1, img_size=IMG)
    split = _split(4, 18)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trainer.train_baseline(cfg, split, split, num_steps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ensemble_trainer.train_ensemble([cfg], [{}], split, split,
                                        num_epochs=1)
    res = trainer.train_baseline(cfg, split, split, num_steps=0, device="cpu")
    assert res.losses == [] and res.final_loss == 0.0
    assert set(res.metrics) == set(METRIC_KEYS)
