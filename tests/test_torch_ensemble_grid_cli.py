"""The port's two ensemble sweep drivers in their grid (default) and
`--frozen` modes against the JAX package's, on the CPU.

The drivers run in-process through `main(argv)` on `tests/test_cli.py`'s
synthetic dataset (`test_torch_cli.synth_root`), with dropout 0 in both
packages (`no_dropout`), the members from baselines the port writes as
`.bin` (`test_torch_ensemble_cli._baselines`), every conf narrowed in both
grids so the padded templates stay small (`narrow_all`), the grid's meta
head taken from JAX's template (`grid_heads`) and the frozen heads from
JAX's initial draw (`test_torch_e2e_grid._jax_heads`).  The drivers'
metrics are held to 1e-4, as in `tests/test_torch_ensemble_cli.py`.
"""

import json
import logging
import os
import shutil

import numpy as np
import pytest
import torch

import jax

import vit3d_ensemble_tpu.configs as jax_configs
import vit3d_ensemble_tpu.sweep.e2e_grid as jax_grid
from vit3d_ensemble_tpu.cli import train_ensemble_bootstrap as jax_ens_boot
from vit3d_ensemble_tpu.cli import train_ensemble_cv as jax_ens_cv
import vit3d_ensemble_tpu_torch.configs as configs
from vit3d_ensemble_tpu_torch.cli import train_ensemble_bootstrap as ens_boot_driver
from vit3d_ensemble_tpu_torch.cli import train_ensemble_cv as ens_cv_driver
from vit3d_ensemble_tpu_torch.configs import ViTConfig
from vit3d_ensemble_tpu_torch.models import TransformerEnsemble
from vit3d_ensemble_tpu_torch.sweep import e2e_grid, ensemble_sweep

import test_torch_cli as base
import test_torch_ensemble_cli as ens
from test_torch_e2e_grid import _jax_heads

IMG = base.IMG
ENSEMBLE = ens.ENSEMBLE
synth_root = base.synth_root
no_dropout = base.no_dropout
_restore_impls = base._restore_impls
_paths = base._paths
_close = base._close
_float_metrics = ens._float_metrics


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the port's many small CPU ops: under xdist's
    six workers the default (every core in each worker) oversubscribes the
    CPU, which slows these eager loops far more than it speeds them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture()
def narrow_all(monkeypatch):
    """Confs 1-3 as `test_torch_ensemble_cli.NARROW`, every other conf at its
    (hidden, heads) class with 32 FFN columns and one layer, in both grids:
    the templates the grid pads to are then 48 columns and 2 layers wide."""
    for grid in (configs.GRID, jax_configs.GRID):
        for conf, (ps, _, _, hs, nh) in list(grid.items()):
            monkeypatch.setitem(grid, conf, ens.NARROW.get(conf, (ps, 32, 1, hs, nh)))


@pytest.fixture()
def grid_heads(monkeypatch):
    """The port's grid starts each signature from the meta head of the JAX
    grid's template (`e2e_grid.py:518-522`), recorded by wrapping JAX's
    `init_ensemble`; it depends on the number of members and the seed."""
    heads = {}
    real = jax_grid.init_ensemble

    def record(sig_cfgs, member_params, seed):
        model, params = real(sig_cfgs, member_params, seed)
        meta = jax.device_get(params)["meta"]["classifier"]
        heads[(len(sig_cfgs), seed)] = (np.asarray(meta["kernel"]).T,
                                        np.asarray(meta["bias"]))
        return model, params

    monkeypatch.setattr(jax_grid, "init_ensemble", record)
    monkeypatch.setattr(e2e_grid, "_template_head", lambda k, nc, seed: tuple(
        torch.from_numpy(a.copy()) for a in heads[(k, seed)]))
    return heads


@pytest.fixture()
def jax_meta_heads(monkeypatch):
    monkeypatch.setattr(ensemble_sweep, "init_meta_heads", _jax_heads)


def _dirs(tmp_path, confs=(1, 2, 3)):
    for sub in ("jax", "port"):
        ens._baselines(tmp_path / sub, confs)
    return tmp_path / "jax", tmp_path / "port"


def _markers(out):
    state = out / "sweep_state"
    return {name: json.loads((state / name).read_text())
            for name in sorted(os.listdir(state))}


def _ensemble_layout(path, confs):
    want = TransformerEnsemble([ViTConfig.from_conf(c, img_size=IMG) for c in confs],
                               device="cpu").state_dict()
    got = torch.load(path, weights_only=True)
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in want.items()}


def _no_training(monkeypatch, driver):
    def must_not_train(*a, **k):
        raise AssertionError("a completed combination trained again")

    monkeypatch.setattr(driver, "run_e2e_grid", must_not_train)


# --- the grid -------------------------------------------------------------------


def test_train_ensemble_cv_grid_matches_jax(synth_root, tmp_path, narrow_all,
                                            no_dropout, grid_heads):
    """The default grid, --max_configs 4 (the one combination {1,2,3}) over
    two folds: the val and held-out test metrics within 1e-4 of the JAX
    driver's (measured: 3.6e-7 and 3.2e-7), JAX's marker names and keys,
    both reports, and with --save_ensembles the sequential mode's `.bin`
    layout."""
    jax_out, out = _dirs(tmp_path)
    argv = ["--max_configs", "4", "--num_cv", "2", "--save_ensembles", *ENSEMBLE]
    ref = jax_ens_cv.main([*argv, *_paths(synth_root, jax_out, "cross_validation")])
    ours = ens_cv_driver.main([*argv, "--device", "cpu",
                               *_paths(synth_root, out, "cross_validation")])
    assert list(ours) == ["1_2_3"] and list(ours["1_2_3"]) == ["CV 1", "CV 2"]
    for fold in ref["1_2_3"]:
        _close(ours["1_2_3"][fold], _float_metrics(ref["1_2_3"][fold]), fold)
    markers, ref_markers = _markers(out), _markers(jax_out)
    assert list(markers) == list(ref_markers)
    (marker,), (ref_marker,) = markers.values(), ref_markers.values()
    assert list(marker) == list(ref_marker) == ["combo", "fingerprint", "val", "test"]
    assert marker["combo"] == [1, 2, 3] and marker["val"] == ours["1_2_3"]
    for fold, m in ref_marker["test"].items():
        _close(marker["test"][fold], m, f"test {fold}")
    for name in ("Ensemble_CV", "Ensemble_CV_test"):
        assert (out / f"{name}.csv").exists() and (out / f"{name}.xlsx").exists()
        assert (jax_out / f"{name}.csv").exists()
    for f in (1, 2):
        _ensemble_layout(out / "cv_ensemble_models" / "ensemble_1_2_3" / f"cv{f}.bin",
                         (1, 2, 3))


def test_train_ensemble_cv_grid_resume_mirror_and_backfill(synth_root, tmp_path,
                                                           narrow_all, no_dropout,
                                                           monkeypatch):
    """--resume returns the same dict without training; --state_mirror
    restores the markers after `sweep_state/` is deleted; a legacy val-only
    marker is re-queued under --backfill_test (the default), retrained and
    upgraded in place to {"combo", "fingerprint", "val", "test"}."""
    ens._baselines(tmp_path)
    argv = ["--max_configs", "4", "--num_cv", "2", *ENSEMBLE, "--device", "cpu",
            *_paths(synth_root, tmp_path, "cross_validation")]
    first = ens_cv_driver.main(argv)
    (name, marker), = _markers(tmp_path).items()
    real = ens_cv_driver.run_e2e_grid
    _no_training(monkeypatch, ens_cv_driver)
    assert ens_cv_driver.main([*argv, "--resume"]) == first
    mirror = tmp_path / "mirror" / "state.jsonl"
    assert ens_cv_driver.main([*argv, "--resume", "--state_mirror", str(mirror)]) == first
    shutil.rmtree(tmp_path / "sweep_state")
    assert ens_cv_driver.main([*argv, "--resume", "--state_mirror", str(mirror)]) == first
    assert _markers(tmp_path) == {name: marker}

    (tmp_path / "sweep_state" / name).write_text(json.dumps(marker["val"]))
    trained = []
    monkeypatch.setattr(ens_cv_driver, "run_e2e_grid",
                        lambda todo, *a, **k: trained.append(list(todo)) or real(todo, *a, **k))
    again = ens_cv_driver.main([*argv, "--resume"])
    assert trained == [[(1, 2, 3)]]
    assert again == first and _markers(tmp_path) == {name: marker}


def test_train_ensemble_bootstrap_grid_matches_jax(synth_root, tmp_path, narrow_all,
                                                   no_dropout, grid_heads, monkeypatch):
    """The default grid, --max_configs 4 over two replicates: the val and
    held-out test metrics within 1e-4 of the JAX driver's (measured: 5.4e-7
    and 5.7e-7), JAX's `boot_*` marker names and keys, both reports,
    `bootstrap_{0,1}.bin` in the sequential mode's layout; --resume returns
    the same dicts without training."""
    jax_out, out = _dirs(tmp_path)
    argv = ["--max_configs", "4", "--num_rep", "2", "--save_ensembles", *ENSEMBLE]
    ref_val, ref_test = jax_ens_boot.main([*argv, *_paths(synth_root, jax_out,
                                                          "fixed_split")])
    port_argv = [*argv, "--device", "cpu", *_paths(synth_root, out, "fixed_split")]
    val, test = ens_boot_driver.main(port_argv)
    assert list(val) == list(test) == ["1_2_3"]
    for rep in ("boot0", "boot1"):
        _close(val["1_2_3"][rep], _float_metrics(ref_val["1_2_3"][rep]), f"val {rep}")
        _close(test["1_2_3"][rep], _float_metrics(ref_test["1_2_3"][rep]), f"test {rep}")
    markers, ref_markers = _markers(out), _markers(jax_out)
    assert list(markers) == list(ref_markers)
    assert all(name.startswith("boot_1_2_3_2rep_") for name in markers)
    (marker,), (ref_marker,) = markers.values(), ref_markers.values()
    assert list(marker) == list(ref_marker) == ["combo", "val", "test"]
    for name in ("Ensemble_Bootstrap", "Ensemble_Bootstrap_test"):
        assert (out / f"{name}.csv").exists() and (out / f"{name}.xlsx").exists()
    for rep in (0, 1):
        _ensemble_layout(out / "bootstrap_ensemble_models" / "ensemble_1_2_3"
                         / f"bootstrap_{rep}.bin", (1, 2, 3))
    _no_training(monkeypatch, ens_boot_driver)
    assert ens_boot_driver.main([*port_argv, "--resume"]) == (val, test)


# --- the frozen meta-head sweep ---------------------------------------------------


def _meta_heads(out, kind, name):
    return torch.load(out / f"{kind}_models" / f"ensemble_{name}" / "meta_heads.bin",
                      weights_only=True)


def test_train_ensemble_cv_frozen_matches_jax(synth_root, tmp_path, narrow_all,
                                              no_dropout, jax_meta_heads):
    """--frozen over confs 1-5 (10 combinations), two folds: every
    combination's val metrics within 1e-4 of the JAX driver's (measured:
    1.2e-7); `meta_heads.bin` with `combo` and the (F, 4) `meta_wb`."""
    confs = (1, 2, 3, 4, 5)
    jax_out, out = _dirs(tmp_path, confs)
    argv = ["--frozen", "--max_configs", "6", "--num_cv", "2", *ENSEMBLE]
    ref = jax_ens_cv.main([*argv, *_paths(synth_root, jax_out, "cross_validation")])
    ours = ens_cv_driver.main([*argv, "--device", "cpu",
                               *_paths(synth_root, out, "cross_validation")])
    assert list(ours) == list(ref) and len(ours) == 10
    for name in ref:
        for fold in ref[name]:
            _close(ours[name][fold], _float_metrics(ref[name][fold]), f"{name} {fold}")
    heads = _meta_heads(out, "cv_ensemble", "1_3_5")
    assert heads["combo"].tolist() == [1, 3, 5] and heads["meta_wb"].shape == (2, 4)
    assert (out / "Ensemble_CV.csv").exists()


def test_train_ensemble_bootstrap_frozen_matches_jax(synth_root, tmp_path, narrow_all,
                                                     no_dropout, jax_meta_heads):
    """--frozen over confs 1-4 (4 combinations), two replicates: the val and
    held-out test metrics within 1e-4 of the JAX driver's (measured: 6.0e-8
    and 6.0e-8); `meta_heads.bin` and both reports."""
    confs = (1, 2, 3, 4)
    jax_out, out = _dirs(tmp_path, confs)
    argv = ["--frozen", "--max_configs", "5", "--num_rep", "2", *ENSEMBLE]
    ref_val, ref_test = jax_ens_boot.main([*argv, *_paths(synth_root, jax_out,
                                                          "fixed_split")])
    val, test = ens_boot_driver.main([*argv, "--device", "cpu",
                                      *_paths(synth_root, out, "fixed_split")])
    assert list(val) == list(test) == list(ref_val) and len(val) == 4
    for name in ref_val:
        for rep in ref_val[name]:
            _close(val[name][rep], _float_metrics(ref_val[name][rep]), f"val {name} {rep}")
            _close(test[name][rep], _float_metrics(ref_test[name][rep]),
                   f"test {name} {rep}")
    heads = _meta_heads(out, "bootstrap_ensemble", "2_3_4")
    assert heads["combo"].tolist() == [2, 3, 4] and heads["meta_wb"].shape == (2, 4)
    for name in ("Ensemble_Bootstrap", "Ensemble_Bootstrap_test"):
        assert (out / f"{name}.csv").exists()


def test_sequential_mode_warns_about_grid_flags(caplog):
    """--no-padded_compile ignores the grid-only flags, as the JAX driver
    does, and says so."""
    args = ens_cv_driver.build_parser().parse_args(
        ["--no-padded_compile", "--e2e_chunk", "2", "--state_mirror", "m.jsonl"])
    with caplog.at_level(logging.WARNING):
        ens_cv_driver.sequential_mode(args, "train_ensemble_cv")
    assert "--e2e_chunk, --state_mirror" in caplog.text
    caplog.clear()
    ens_cv_driver.sequential_mode(ens_cv_driver.build_parser().parse_args(
        ["--no-padded_compile"]), "train_ensemble_cv")
    assert not caplog.text
