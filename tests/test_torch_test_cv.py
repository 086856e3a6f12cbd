"""The port's test/statistics driver and `metrics/stats.py` against the JAX
package's, on the CPU.

One set of weights is written in both packages' formats under one output
directory: JAX's `.msgpack` through its checkpoint helpers and the port's
`.bin` through `vit_state_from_flax` / `ensemble_state_from_flax` and
`save_state_dict` (per-fold baselines, whole-dataset baselines,
end-to-end `cv{k}` ensembles and frozen `meta_heads`), beside marker JSONs
that both read.  Both `main`s then run in-process on `tests/test_cli.py`'s
synthetic dataset (8 patients at 32 px, two CV folds; the port with
`--device cpu`), with confs 1-3 narrowed in both grids
(`test_torch_ensemble_cli.NARROW`).  Fold metrics agree within 1e-6 and the
statistics within the same relative bound; reports are byte-equal.
"""

import json
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vit3d_ensemble_tpu import checkpoint as jax_ckpt
from vit3d_ensemble_tpu.cli import test_cv as jax_test_cv
from vit3d_ensemble_tpu.configs import ViTConfig as JaxViTConfig
from vit3d_ensemble_tpu.metrics import stats as jax_stats
from vit3d_ensemble_tpu.models import VisionTransformer3D as JaxVisionTransformer3D
from vit3d_ensemble_tpu_torch import checkpoint
from vit3d_ensemble_tpu_torch.checkpoint import ensemble_state_from_flax, vit_state_from_flax
from vit3d_ensemble_tpu_torch.cli import test_cv
from vit3d_ensemble_tpu_torch.cli import train_ensemble_cv as ens_cv_driver
from vit3d_ensemble_tpu_torch.configs import ViTConfig
from vit3d_ensemble_tpu_torch.metrics import METRIC_KEYS, stats
from vit3d_ensemble_tpu_torch.utils import profiling, step_annotation

import test_torch_cli as base
import test_torch_ensemble_cli as ens

IMG = base.IMG
CV = 2
#: Fold metrics and statistics, port against JAX.
ATOL = 1e-6
synth_root = base.synth_root
narrow = ens.narrow
_paths = base._paths
_restore_impls = base._restore_impls


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the port's small CPU ops (as
    `tests/test_torch_e2e_grid.py`)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --- weights in both formats ------------------------------------------------------


_INITS = {}


def _vit_params(conf, seed):
    """A JAX baseline's parameters, its head drawn (not zero); one jitted
    init a (narrowed) conf."""
    cfg = JaxViTConfig.from_conf(conf, img_size=IMG)
    if cfg not in _INITS:
        model = JaxVisionTransformer3D(cfg, zero_head=False, vis=False)
        _INITS[cfg] = jax.jit(lambda k: model.init(
            {"params": k}, jnp.zeros((1, IMG, IMG, 5, 1)))["params"])
    return jax.device_get(_INITS[cfg](jax.random.key(seed)))


def _write_vit(out, kind, conf, tag, seed):
    params = _vit_params(conf, seed)
    jax_ckpt.save_pytree(jax_ckpt.baseline_ckpt_path(str(out), kind, conf, tag), params)
    checkpoint.save_state_dict(
        checkpoint.baseline_ckpt_path(str(out), kind, conf, tag),
        vit_state_from_flax(params, ViTConfig.from_conf(conf, img_size=IMG)))
    return params


def _write_ensemble(out, confs, tag, seed):
    """An end-to-end ensemble in JAX's `TransformerEnsemble` tree: drawn
    members (not zero heads) and a drawn meta head."""
    rng = np.random.default_rng(seed)
    params = {f"transformer_{i}": _vit_params(c, seed + c) for i, c in enumerate(confs)}
    params["meta"] = {"classifier": {
        "kernel": rng.normal(size=(len(confs), 1)).astype(np.float32),
        "bias": rng.normal(size=(1,)).astype(np.float32)}}
    name = "_".join(map(str, confs))
    jax_ckpt.save_pytree(jax_ckpt.ensemble_ckpt_path(str(out), "cv_ensemble", name, tag),
                         params)
    checkpoint.save_state_dict(
        checkpoint.ensemble_ckpt_path(str(out), "cv_ensemble", name, tag),
        ensemble_state_from_flax(params, [ViTConfig.from_conf(c, img_size=IMG)
                                          for c in confs]))


def _write_meta_heads(out, comb, seed):
    """A combination's (CV, k + 1) heads, as both sweeps' `--frozen` write them."""
    wb = np.random.default_rng(seed).normal(size=(CV, len(comb) + 1)).astype(np.float32)
    name = "_".join(map(str, comb))
    jax_ckpt.save_pytree(jax_ckpt.ensemble_ckpt_path(str(out), "cv_ensemble", name,
                                                     "meta_heads"),
                         {"combo": np.asarray(comb, np.int32), "meta_wb": wb})
    ens_cv_driver.save_meta_heads(types.SimpleNamespace(output_dir=str(out)),
                                  "cv_ensemble", name, np.asarray(comb, np.int32), wb)


def _marker_metrics(rng, folds=CV):
    return {f"CV {f + 1}": {k: float(v) for k, v in zip(METRIC_KEYS, rng.uniform(size=11))}
            for f in range(folds)}


def _write_markers(out, seed=0):
    """The grid's markers: three combinations of one sweep setting, one of
    another (a smaller group), a legacy val-only marker and one of another
    fold count, which both readers skip."""
    rng = np.random.default_rng(seed)
    state = out / "sweep_state"
    state.mkdir(parents=True, exist_ok=True)
    fp = "2cv_2ep_4b_0.005lr_42s_grid"
    for comb in ((1, 2, 3), (1, 2, 4), (2, 3, 4)):
        name = "_".join(map(str, comb))
        (state / f"e2e_{name}_{fp}.json").write_text(json.dumps(
            {"combo": list(comb), "fingerprint": fp, "val": _marker_metrics(rng),
             "test": _marker_metrics(rng)}))
    (state / "e2e_1_3_4_other.json").write_text(json.dumps(
        {"combo": [1, 3, 4], "fingerprint": "other", "val": {},
         "test": _marker_metrics(rng)}))
    (state / "e2e_1_2_5_legacy.json").write_text(json.dumps(_marker_metrics(rng)))
    (state / "e2e_1_2_6_3cv.json").write_text(json.dumps(
        {"combo": [1, 2, 6], "fingerprint": fp, "test": _marker_metrics(rng, 3)}))


# --- comparisons --------------------------------------------------------------------


def _close_folds(ours, ref, where=""):
    assert list(ours) == list(ref), where
    for fold in ref:
        assert list(ours[fold]) == list(ref[fold]), (where, fold)
        for k in ref[fold]:
            assert abs(ours[fold][k] - ref[fold][k]) <= ATOL, (
                where, fold, k, ours[fold][k], ref[fold][k])


def _fields(value):
    if isinstance(value, str):
        return value
    return [float(getattr(value, f)) for f in ("statistic", "pvalue", "median")
            if hasattr(value, f)]


def _same_stats(ours, ref):
    assert list(ours) == list(ref)
    for k in ref:
        a, b = _fields(ours[k]), _fields(ref[k])
        if isinstance(b, str):
            assert a == b, k
        else:
            np.testing.assert_allclose(a, b, rtol=ATOL, atol=ATOL, err_msg=k)


def _run_both(root, jax_out, port_out, argv):
    common = ["--cv", str(CV), "--img_size", str(IMG)]
    ref = jax_test_cv.main([*argv, *common,
                            *_paths(root, jax_out, "cross_validation")])
    ours = test_cv.main([*argv, *common, "--device", "cpu",
                         *_paths(root, port_out, "cross_validation")])
    return ours, ref


# --- stats ------------------------------------------------------------------------


def _per_fold(seed, folds=5):
    rng = np.random.default_rng(seed)
    return {f"CV {f + 1}": {**{k: float(v) for k, v in zip(METRIC_KEYS, rng.uniform(size=11))},
                            "CSP": float(rng.uniform()), "CSE": float(rng.uniform())}
            for f in range(folds)}


def test_aggregate_folds_matches_jax():
    res = _per_fold(0)
    assert stats.aggregate_folds(res) == jax_stats.aggregate_folds(res)
    assert stats.aggregate_folds({}) == {}


@pytest.mark.parametrize("folds", [2, 5])
def test_compute_statistics_matches_jax(tmp_path, folds):
    """The tests, their statistics and p-values equal JAX's (five folds for
    Shapiro-Wilk, two for its note), and the plots written."""
    base_res, ens_res = _per_fold(1, folds), _per_fold(2, folds)
    ours = stats.compute_statistics(base_res, ens_res, str(tmp_path / "plots"))
    ref = jax_stats.compute_statistics(base_res, ens_res, make_plots=False)
    assert list(ours) == list(ref)
    for k in ref:
        assert _fields(ours[k]) == _fields(ref[k]), k
    for name in ("bs_hist.png", "box_plot.eps", "box_plot.png"):
        assert (tmp_path / "plots" / name).stat().st_size > 0


def test_compute_statistics_plots_are_best_effort(tmp_path, monkeypatch, caplog):
    """A plot that cannot be written warns and the statistics come back."""
    import matplotlib.pyplot as plt

    def fail(*a, **k):
        raise RuntimeError("no canvas")

    monkeypatch.setattr(plt, "subplots", fail)
    got = stats.compute_statistics(_per_fold(1), _per_fold(2), str(tmp_path))
    assert "mann_whitney" in got
    assert "could not be written" in caplog.text


def test_step_annotation_names_the_span():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with step_annotation("train", 7):
            torch.ones(4).sum()
    assert "train#7" in {e.key for e in prof.key_averages()}
    assert profiling.step_annotation is step_annotation


# --- the driver -----------------------------------------------------------------------


def test_parser_paths_take_the_bin_layout():
    args = test_cv.build_parser().parse_args(
        ["--base_path", "/x/cv_baseline_models", "--ens_path", "/y/cv_ensemble_models"])
    assert test_cv._cv_baseline_ckpt(args, 5, "cv1") == "/x/cv_baseline_models/conf5/cv1.bin"
    assert (test_cv._cv_ensemble_ckpt(args, "5_9_11", "cv2")
            == "/y/cv_ensemble_models/ensemble_5_9_11/cv2.bin")
    args = test_cv.build_parser().parse_args(["--output_dir", "/o"])
    assert test_cv._cv_baseline_ckpt(args, 5, "cv1") == "/o/cv_baseline_models/conf5/cv1.bin"


def test_baseline_and_end_to_end_ensemble_match_jax(synth_root, tmp_path, narrow):
    """--baseline --ensemble on the fold checkpoints `cv{k}`: both fold
    results within 1e-6, the statistics equal, the plots written; then
    --ood from the same checkpoints, on the same noisy volumes."""
    out = tmp_path / "out"
    for f in range(CV):
        _write_vit(out, "cv_baseline", 1, f"cv{f + 1}", seed=10 + f)
        _write_ensemble(out, (1, 2, 3), f"cv{f + 1}", seed=20 + f)
    argv = ["--baseline", "--ensemble", "--conf", "1", "--ensemble_conf_list", "1,2,3"]
    (ours_b, ours_e, ours_s), (ref_b, ref_e, ref_s) = _run_both(synth_root, out, out, argv)
    _close_folds(ours_b, ref_b, "baseline")
    _close_folds(ours_e, ref_e, "ensemble")
    _same_stats(ours_s, ref_s)
    for name in ("bs_hist.png", "box_plot.eps", "box_plot.png"):
        assert (out / name).exists()

    argv = ["--ensemble", "--ensemble_conf_list", "1,2,3", "--ood", "--ood_var", "100.0"]
    (_, ood, _), (_, ref_ood, _) = _run_both(synth_root, out, out, argv)
    _close_folds(ood, ref_ood, "ood")
    assert [m["BS"] for m in ood.values()] != [m["BS"] for m in ours_e.values()]
    args = test_cv.build_parser().parse_args(
        [*argv, *_paths(synth_root, out, "cross_validation"), "--img_size", str(IMG)])
    for f in range(CV):
        np.testing.assert_array_equal(test_cv._fold_test_split(args, f).volumes,
                                      jax_test_cv._fold_test_split(args, f).volumes)


def test_frozen_meta_heads_match_jax(synth_root, tmp_path, narrow):
    """--baseline --ensemble from `meta_heads` over the whole-dataset
    baselines' logits, then --all_ensembles from every combination's heads
    (--combinations 2: three heads of two members): the same results,
    ranking and report, byte for byte."""
    out = tmp_path / "out"
    for f in range(CV):
        _write_vit(out, "cv_baseline", 2, f"cv{f + 1}", seed=30 + f)
    for c in (1, 2, 3):
        _write_vit(out, "baseline", c, f"conf{c}", seed=c)
    _write_meta_heads(out, (1, 2, 3), seed=0)
    for i, comb in enumerate(((1, 2), (1, 3), (2, 3))):
        _write_meta_heads(out, comb, seed=1 + i)
    argv = ["--baseline", "--ensemble", "--conf", "2", "--ensemble_conf_list", "1,2,3"]
    (ours_b, ours_e, ours_s), (ref_b, ref_e, ref_s) = _run_both(synth_root, out, out, argv)
    _close_folds(ours_b, ref_b, "baseline")
    _close_folds(ours_e, ref_e, "meta heads")
    _same_stats(ours_s, ref_s)

    args = ["--all_ensembles", "--max_configs", "4", "--combinations", "2"]
    ours_dir, ref_dir = tmp_path / "port_report", tmp_path / "jax_report"
    ours = test_cv.test_all_ensembles(test_cv.build_parser().parse_args(
        [*args, "--cv", str(CV), "--img_size", str(IMG), "--device", "cpu",
         "--output_path", str(ours_dir), *_paths(synth_root, out, "cross_validation")]))
    ref = jax_test_cv.test_all_ensembles(jax_test_cv.build_parser().parse_args(
        [*args, "--cv", str(CV), "--img_size", str(IMG),
         "--output_path", str(ref_dir), *_paths(synth_root, out, "cross_validation")]))
    assert [n for n, _ in ours[1]] == [n for n, _ in ref[1]]
    np.testing.assert_allclose([a for _, a in ours[1]], [a for _, a in ref[1]], atol=ATOL)
    assert list(ours[0]) == ["1_2", "1_3", "2_3"]
    for name in ref[0]:
        _close_folds(ours[0][name], ref[0][name], name)
    assert ((ours_dir / "Test_All_Ensembles.csv").read_bytes()
            == (ref_dir / "Test_All_Ensembles.csv").read_bytes())
    assert (ours_dir / "Test_All_Ensembles.xlsx").exists()


def test_markers_match_jax(synth_root, tmp_path, caplog):
    """No checkpoints: --ensemble reads its combination's held-out test
    metrics from the grid's markers, and --all_ensembles ranks the largest
    fingerprint group (JAX's rule, with its warnings); the same results,
    ranking and report, byte for byte."""
    out = tmp_path / "out"
    _write_markers(out)
    (_, ours, _), (_, ref, _) = _run_both(
        synth_root, out, out, ["--ensemble", "--ensemble_conf_list", "1,2,3"])
    assert ours == ref and list(ours) == ["CV 1", "CV 2"]

    args = ["--all_ensembles", "--cv", str(CV)]
    ours_dir, ref_dir = tmp_path / "port_report", tmp_path / "jax_report"
    caplog.clear()
    res, ranking = test_cv.test_all_ensembles(test_cv.build_parser().parse_args(
        [*args, "--device", "cpu", "--output_path", str(ours_dir),
         *_paths(synth_root, out, "cross_validation")]))
    assert "legacy val-only schema" in caplog.text and "2 different sweep" in caplog.text
    ref_res, ref_ranking = jax_test_cv.test_all_ensembles(
        jax_test_cv.build_parser().parse_args(
            [*args, "--output_path", str(ref_dir),
             *_paths(synth_root, out, "cross_validation")]))
    assert res == ref_res and ranking == ref_ranking
    assert sorted(res) == ["1_2_3", "1_2_4", "2_3_4"]
    assert ((ours_dir / "Test_All_Ensembles.csv").read_bytes()
            == (ref_dir / "Test_All_Ensembles.csv").read_bytes())


def test_missing_checkpoints_raise(synth_root, tmp_path, narrow):
    argv = ["--cv", str(CV), "--img_size", str(IMG), "--device", "cpu",
            *_paths(synth_root, tmp_path, "cross_validation")]
    with pytest.raises(FileNotFoundError, match="no ensemble checkpoint"):
        test_cv.main(["--ensemble", "--ensemble_conf_list", "1,2,3", "--ood", *argv])
    for c in (1, 2, 3):
        _write_vit(tmp_path, "baseline", c, f"conf{c}", seed=c)
    with pytest.raises(FileNotFoundError, match="no trained meta_heads"):
        test_cv.main(["--all_ensembles", "--max_configs", "4", *argv])


def test_needs_a_card_unless_given_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        test_cv.main(["--baseline", "--output_dir", str(tmp_path)])
