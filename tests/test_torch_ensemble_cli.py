"""The port's bootstrap and ensemble drivers, reports and checkpoints
against the JAX package's, on the CPU.

The drivers run in-process through `main(argv)` on `tests/test_cli.py`'s
synthetic dataset (8 patients at 32 px, two CV folds and the fixed split),
with dropout 0 in both packages and the port started from the weights of
the JAX run (`test_torch_cli`'s `no_dropout` patches, and `jax_inits` here
for the ensembles' `init_ensemble`, through `ensemble_state_from_flax`).
The ensembles' members are the baselines the port writes as `.bin`, which
both packages read; confs 1-3 are narrowed in both packages' grids (32-48
columns, 1-2 layers) to keep the JAX programs small.  Tolerances: the
drivers' metrics 1e-4, ensemble probabilities 2e-5
(`tests/test_model_parity.py:165`), chunk invariance 1e-6
(`tests/test_cli.py:127`).
"""

import csv
import dataclasses
import json
import os
import zipfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import vit3d_ensemble_tpu.configs as jax_configs
from vit3d_ensemble_tpu import reporting as jax_reporting
from vit3d_ensemble_tpu.checkpoint import load_baseline_params as jax_load_baseline
from vit3d_ensemble_tpu.checkpoint import torch_ensemble_to_flax
from vit3d_ensemble_tpu.cli import train_baseline_bootstrap as jax_boot
from vit3d_ensemble_tpu.cli import train_ensemble_bootstrap as jax_ens_boot
from vit3d_ensemble_tpu.cli import train_ensemble_cv as jax_ens_cv
from vit3d_ensemble_tpu.cli import train_ensemble_whole_dataset as jax_ens_whole
from vit3d_ensemble_tpu.configs import ViTConfig as JaxViTConfig
from vit3d_ensemble_tpu.models import TransformerEnsemble as JaxTransformerEnsemble
from vit3d_ensemble_tpu.train import ensemble_trainer as jax_ensemble_trainer
import vit3d_ensemble_tpu_torch.configs as configs
from vit3d_ensemble_tpu_torch import checkpoint, reporting
from vit3d_ensemble_tpu_torch.checkpoint import ensemble_state_from_flax
from vit3d_ensemble_tpu_torch.cli import train_baseline_bootstrap as boot_driver
from vit3d_ensemble_tpu_torch.cli import train_ensemble_bootstrap as ens_boot_driver
from vit3d_ensemble_tpu_torch.cli import train_ensemble_cv as ens_cv_driver
from vit3d_ensemble_tpu_torch.cli import train_ensemble_whole_dataset as ens_whole_driver
from vit3d_ensemble_tpu_torch.configs import ViTConfig
from vit3d_ensemble_tpu_torch.models import TransformerEnsemble, VisionTransformer3D
from vit3d_ensemble_tpu_torch.train import ensemble_trainer, trainer
from vit3d_ensemble_tpu_torch.train.optim import adam

import test_torch_cli as base

IMG = base.IMG
METRICS_ATOL = base.METRICS_ATOL
#: Ensemble probabilities, port against JAX (`tests/test_model_parity.py:165`).
PROBS_ATOL = 2e-5
#: The bootstrap driver's metrics across --boot_chunk (`tests/test_cli.py:127`).
CHUNK_ATOL = 1e-6
#: Confs 1-3 narrowed in both grids: (patch, mlp, layers, hidden, heads).
NARROW = {1: (16, 32, 1, 16, 4), 2: (16, 48, 2, 16, 4), 3: (16, 32, 1, 32, 8)}
ENSEMBLE = ["--num_epochs", "2", "--learning_rate", "0.005", "--img_size", str(IMG)]
BOOT = ["--num_steps", "4", "--eval_every", "2", "--warmup_steps", "2",
        "--learning_rate", "0.05", "--img_size", str(IMG)]

synth_root = base.synth_root
no_dropout = base.no_dropout
_restore_impls = base._restore_impls
_paths = base._paths
_close = base._close


@pytest.fixture()
def narrow(monkeypatch):
    for grid in (configs.GRID, jax_configs.GRID):
        for conf, row in NARROW.items():
            monkeypatch.setitem(grid, conf, row)


@pytest.fixture()
def jax_inits(monkeypatch):
    """Each of the port's ensembles starts from the parameters that the JAX
    run's `init_ensemble` gave the same call (its loaded members and its
    meta head), converted by `ensemble_state_from_flax`."""
    inits = []
    real = jax_ensemble_trainer.init_ensemble

    def record(configs_, member_params, seed=42):
        model, params = real(configs_, member_params, seed)
        inits.append(jax.device_get(params))
        return model, params

    def port_init(configs_, member_params, seed=42, device=None):
        model = TransformerEnsemble(tuple(configs_), device=device)
        model.load_state_dict(ensemble_state_from_flax(inits.pop(0), configs_))
        for member, state in zip(model.transformers, member_params):
            for k, v in member.state_dict().items():
                assert torch.equal(v, state[k].to(v.device)), k
        return model

    monkeypatch.setattr(jax_ensemble_trainer, "init_ensemble", record)
    monkeypatch.setattr(ensemble_trainer, "init_ensemble", port_init)
    return inits


def _baselines(out, confs=(1, 2, 3)):
    """Baseline checkpoints written by the port, as
    `train_baseline_whole_dataset` writes them: conf c drawn from seed c."""
    for c in confs:
        state = VisionTransformer3D(
            ViTConfig.from_conf(c, img_size=IMG), device="cpu",
            generator=torch.Generator().manual_seed(c)).state_dict()
        checkpoint.save_state_dict(
            checkpoint.baseline_ckpt_path(str(out), "baseline", c, f"conf{c}"), state)


def _both_dirs(tmp_path):
    for sub in ("jax", "port"):
        _baselines(tmp_path / sub)
    return tmp_path / "jax", tmp_path / "port"


def _float_metrics(m):
    return {k: float(v) for k, v in m.items()}


# --- flags ----------------------------------------------------------------------

DRIVERS = [(boot_driver, jax_boot), (ens_whole_driver, jax_ens_whole),
           (ens_cv_driver, jax_ens_cv), (ens_boot_driver, jax_ens_boot)]
DRIVER_IDS = ["train_baseline_bootstrap", "train_ensemble_whole_dataset",
              "train_ensemble_cv", "train_ensemble_bootstrap"]


@pytest.mark.parametrize("ours,ref", DRIVERS, ids=DRIVER_IDS)
def test_parsers_take_the_jax_flags_and_defaults(ours, ref):
    """Every flag of the JAX driver, under the same names, dest, type and
    action, with the same default but for `test_torch_cli.DIFFERENT`."""
    base.test_parsers_take_the_jax_flags_and_defaults(ours, ref)


@pytest.mark.parametrize("driver", [d for d, _ in DRIVERS], ids=DRIVER_IDS)
def test_drivers_need_a_card_unless_given_cpu(driver, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        driver.main(["--output_dir", str(tmp_path)])


def test_frozen_and_end_to_end_exclude_each_other(tmp_path):
    with pytest.raises(SystemExit, match="mutually exclusive"):
        ens_cv_driver.main(["--frozen", "--end_to_end", "--device", "cpu",
                            "--output_dir", str(tmp_path)])


# --- reports and checkpoints ----------------------------------------------------


def test_write_sweep_report_matches_jax(tmp_path):
    """The same results dict: a byte-equal CSV and a workbook whose zip
    members have the same names and contents."""
    rng = np.random.default_rng(3)
    keys = ["Specificity", "Sensitivity", "Accuracy", "AUROC", "AUPRC",
            "F2-score", "CSP", "CSE", "BSNC", "BSPC", "BS"]
    results = {name: {f"boot{r}": {k: float(rng.random()) for k in keys}
                      for r in range(3)}
               for name in ("1_2_3", "5_9_11", "conf<&>")}
    reporting.write_sweep_report(str(tmp_path / "ours"), results)
    jax_reporting.write_sweep_report(str(tmp_path / "ref"), results)
    assert ((tmp_path / "ours.csv").read_bytes()
            == (tmp_path / "ref.csv").read_bytes())
    with open(tmp_path / "ours.csv") as f:
        assert len(list(csv.reader(f))) == 4
    with zipfile.ZipFile(tmp_path / "ours.xlsx") as a, \
            zipfile.ZipFile(tmp_path / "ref.xlsx") as b:
        assert a.namelist() == b.namelist()
        for name in b.namelist():
            assert a.read(name) == b.read(name), name


def test_ensemble_ckpt_path_layout():
    assert checkpoint.ensemble_ckpt_path("out", "cv_ensemble", "5_9_11", "cv2") == \
        os.path.join("out", "cv_ensemble_models", "ensemble_5_9_11", "cv2.bin")


def test_load_baseline_params_reads_the_port_bin(tmp_path, narrow):
    """A port `.bin` reads back as the member's state dict in the port and,
    through `torch_vit_to_flax`, in the JAX package; a checkpoint of another
    config or another format raises."""
    _baselines(tmp_path, confs=(2,))
    path = checkpoint.baseline_ckpt_path(str(tmp_path), "baseline", 2, "conf2")
    cfg = ViTConfig.from_conf(2, img_size=IMG)
    state = checkpoint.load_baseline_params(path, cfg)
    want = VisionTransformer3D(cfg, device="cpu",
                               generator=torch.Generator().manual_seed(2)).state_dict()
    assert state.keys() == want.keys()
    assert all(torch.equal(state[k], want[k]) for k in want)
    jax_params = jax_load_baseline(path, JaxViTConfig.from_conf(2, img_size=IMG))
    back = checkpoint.vit_state_from_flax(jax_params, cfg)
    assert all(torch.equal(back[k], want[k]) for k in want)
    with pytest.raises(ValueError, match="not a checkpoint of this config"):
        checkpoint.load_baseline_params(path, ViTConfig.from_conf(1, img_size=IMG))
    with pytest.raises(ValueError, match=".bin state dicts only"):
        checkpoint.load_baseline_params(path[:-4] + ".msgpack", cfg)


def test_train_state_round_trip(tmp_path):
    """`save_train_state` then `restore_train_state`: the parameters, Adam's
    moments and step count, the step and the metadata come back equal; a
    snapshot of another model raises."""
    cfg = ViTConfig(patch_size=(16, 16, 5), hidden_size=16, num_heads=4,
                    mlp_dim=32, num_layers=1, img_size=IMG)
    model = trainer.init_baseline(cfg, seed=0, device="cpu")
    opt = adam(model.parameters(), 1e-3)
    x = torch.randn(2, IMG, IMG, 5, 1)
    model(x, deterministic=True).logits.sum().backward()
    opt.step()
    path = str(tmp_path / "state" / "train_state.pt")
    checkpoint.save_train_state(path, model.state_dict(), opt.state_dict(), 7,
                                meta={"fold": 2, "name": "5_9_11"})
    fresh = trainer.init_baseline(cfg, seed=1, device="cpu")
    fresh_opt = adam(fresh.parameters(), 1e-3)
    params, opt_state, step, meta = checkpoint.restore_train_state(
        path, fresh.state_dict(), fresh_opt.state_dict())
    assert step == 7 and meta == {"fold": 2, "name": "5_9_11"}
    assert all(torch.equal(params[k], v) for k, v in model.state_dict().items())
    fresh.load_state_dict(params)
    fresh_opt.load_state_dict(opt_state)
    for a, b in zip(opt.state_dict()["state"].values(),
                    fresh_opt.state_dict()["state"].values()):
        assert all(torch.equal(torch.as_tensor(a[k]), torch.as_tensor(b[k])) for k in a)
    other = trainer.init_baseline(dataclasses.replace(cfg, num_layers=2), seed=0,
                                  device="cpu")
    with pytest.raises(ValueError, match="parameters are not the target's"):
        checkpoint.restore_train_state(path, other.state_dict(),
                                       adam(other.parameters(), 1e-3).state_dict())


# --- the baseline bootstrap driver -----------------------------------------------


def test_train_baseline_bootstrap_matches_jax(synth_root, tmp_path, no_dropout):
    """conf 9, two replicates in one chunk: every replicate's 11 metrics
    within 1e-4 of the JAX driver's (measured: 8.9e-8);
    `boot_baseline_models/conf9/boot1.bin` with the member's shapes and the
    `Baseline_Bootstrap` report."""
    argv = ["--config", "9", "--num_rep", "2", *BOOT]
    ref = jax_boot.main([*argv, *_paths(synth_root, tmp_path / "jax", "fixed_split")])
    out = tmp_path / "port"
    ours = boot_driver.main([*argv, "--device", "cpu",
                             *_paths(synth_root, out, "fixed_split")])
    assert list(ours) == ["conf9"] and list(ours["conf9"]) == ["boot0", "boot1"]
    for rep in ref["conf9"]:
        _close(ours["conf9"][rep], ref["conf9"][rep], rep)
    base._checkpoint_shapes(out / "boot_baseline_models" / "conf9" / "boot1.bin", 9)
    _close_reports(out / "Baseline_Bootstrap.csv",
                   tmp_path / "jax" / "Baseline_Bootstrap.csv")
    with zipfile.ZipFile(out / "Baseline_Bootstrap.xlsx") as z:
        assert "xl/worksheets/sheet1.xml" in z.namelist()


def _close_reports(ours, ref):
    """Two reports' rows, their 'mean (std)' cells within 1e-3 (the cells
    are rounded to 3 places, so a 1e-4 difference can move the last)."""
    with open(ours) as a, open(ref) as b:
        rows_a, rows_b = list(csv.reader(a)), list(csv.reader(b))
    assert [r[0] for r in rows_a] == [r[0] for r in rows_b]
    for ra, rb in zip(rows_a[1:], rows_b[1:]):
        for ca, cb in zip(ra[1:], rb[1:]):
            np.testing.assert_allclose(
                [float(t.strip("()")) for t in ca.split()],
                [float(t.strip("()")) for t in cb.split()], atol=1e-3)


def test_train_baseline_bootstrap_chunk_invariant(synth_root, tmp_path):
    """Dropout on: --boot_chunk 1 and 2 give every replicate's metrics
    within 1e-6, as `tests/test_cli.py:105-127` holds the JAX driver: each
    cell's dropout stream is keyed on its global replicate id (measured:
    6.0e-8, from the batched products of one and two cells)."""
    argv = ["--config", "9", "--num_rep", "2", *BOOT, "--device", "cpu",
            "--csv_path", str(synth_root / "csv_files" / "fixed_split"),
            "--data_root", str(synth_root / "dataset")]
    assert ViTConfig.from_conf(9).dropout_rate > 0
    r1 = boot_driver.main([*argv, "--boot_chunk", "1", "--output_dir",
                           str(tmp_path / "c1")])
    r2 = boot_driver.main([*argv, "--boot_chunk", "2", "--output_dir",
                           str(tmp_path / "c2")])
    assert set(r1["conf9"]) == {"boot0", "boot1"}
    for b, m in r1["conf9"].items():
        for k, v in m.items():
            assert abs(v - r2["conf9"][b][k]) <= CHUNK_ATOL, (b, k)
    assert sorted(os.listdir(tmp_path / "c1" / "boot_baseline_models" / "conf9")) == [
        "boot0.bin", "boot1.bin"]


# --- the ensemble drivers --------------------------------------------------------


def _jax_probs(state_path, confs, vols):
    """The JAX ensemble's probabilities from a port `.bin`, through JAX's
    `torch_ensemble_to_flax`."""
    state = torch.load(state_path, weights_only=True)
    jcfgs = tuple(JaxViTConfig.from_conf(c, img_size=IMG) for c in confs)
    params = torch_ensemble_to_flax({k: v.numpy() for k, v in state.items()}, jcfgs)
    return np.asarray(JaxTransformerEnsemble(jcfgs).apply(
        {"params": params}, jnp.asarray(vols), deterministic=True)).reshape(-1)


def _port_probs(state_path, confs, vols):
    cfgs = [ViTConfig.from_conf(c, img_size=IMG) for c in confs]
    model = TransformerEnsemble(cfgs, device="cpu")
    model.load_state_dict(torch.load(state_path, weights_only=True))
    with torch.no_grad():
        return model(torch.from_numpy(vols)).reshape(-1).numpy()


def test_train_ensemble_whole_dataset_matches_jax(synth_root, tmp_path, narrow,
                                                  no_dropout, jax_inits):
    """{1,2,3} from the port's baselines, 2 epochs: the best metrics and
    the confidence metrics and Brier scores within 1e-4 of the JAX
    driver's (measured: 3.2e-7); the best ensemble's `.bin`, read by JAX's
    converter, gives the port's probabilities within 2e-5 (measured:
    equal)."""
    jax_out, out = _both_dirs(tmp_path)
    argv = ["--ensemble_conf_list", "1,2,3", *ENSEMBLE]
    ref = jax_ens_whole.main([*argv, *_paths(synth_root, jax_out, "fixed_split")])
    ours = ens_whole_driver.main([*argv, "--device", "cpu",
                                  *_paths(synth_root, out, "fixed_split")])
    assert not jax_inits
    _close(ours, _float_metrics(ref), "whole")
    saved = out / "best_ensemble_models" / "ensemble_1_2_3" / "best_ensemble_model.bin"
    vols = np.random.default_rng(4).normal(size=(3, IMG, IMG, 5, 1)).astype(np.float32)
    np.testing.assert_allclose(_port_probs(saved, (1, 2, 3), vols),
                               _jax_probs(saved, (1, 2, 3), vols),
                               atol=PROBS_ATOL, rtol=0)


def test_load_members_random_init_and_missing(tmp_path, narrow):
    args = ens_whole_driver.build_parser().parse_args(
        ["--output_dir", str(tmp_path), "--img_size", str(IMG), "--seed", "3"])
    with pytest.raises(FileNotFoundError, match="random_init_members"):
        ens_whole_driver.load_members(args, (1, 2))
    args.random_init_members = True
    cfgs, members = ens_whole_driver.load_members(args, (1, 2))
    assert [c.mlp_dim for c in cfgs] == [32, 48]
    want = trainer.init_baseline(cfgs[1], 3, device="cpu").state_dict()
    assert all(torch.equal(members[1][k], v) for k, v in want.items())


def test_train_ensemble_cv_sequential_matches_jax(synth_root, tmp_path, narrow,
                                                  no_dropout, jax_inits,
                                                  monkeypatch):
    """--no-padded_compile on {1,2,3} over two folds: every fold's 11
    metrics within 1e-4 of the JAX driver's (measured: 3.6e-7),
    `cv_ensemble_models/ensemble_1_2_3/cv{1,2}.bin`, JAX's marker name;
    `--resume` returns the same dict without training."""
    jax_out, out = _both_dirs(tmp_path)
    argv = ["--no-padded_compile", "--ensemble_conf_list", "1,2,3", "--num_cv", "2",
            *ENSEMBLE]
    ref = jax_ens_cv.main([*argv, *_paths(synth_root, jax_out, "cross_validation")])
    port_argv = [*argv, "--device", "cpu", *_paths(synth_root, out, "cross_validation")]
    ours = ens_cv_driver.main(port_argv)
    assert not jax_inits
    assert list(ours) == ["1_2_3"] and list(ours["1_2_3"]) == ["CV 1", "CV 2"]
    for fold in ref["1_2_3"]:
        _close(ours["1_2_3"][fold], _float_metrics(ref["1_2_3"][fold]), fold)
    for f in (1, 2):
        assert (out / "cv_ensemble_models" / "ensemble_1_2_3" / f"cv{f}.bin").exists()
    assert os.listdir(out / "sweep_state") == os.listdir(jax_out / "sweep_state")
    assert (out / "Ensemble_CV.csv").exists() and (out / "Ensemble_CV.xlsx").exists()

    def must_not_train(*a, **k):
        raise AssertionError("a completed combination trained again")

    monkeypatch.setattr(ens_cv_driver, "train_ensemble", must_not_train)
    assert ens_cv_driver.main([*port_argv, "--resume"]) == ours
    marker = out / "sweep_state" / os.listdir(out / "sweep_state")[0]
    assert json.loads(marker.read_text()) == ours["1_2_3"]


def test_train_ensemble_bootstrap_sequential_matches_jax(synth_root, tmp_path, narrow,
                                                         no_dropout, jax_inits):
    """--no-padded_compile, --max_configs 4 (the one combination {1,2,3}),
    two replicates: the validation metrics and the held-out test metrics of
    the best state within 1e-4 of the JAX driver's (measured: 5.4e-7 and
    5.7e-7);
    `bootstrap_ensemble_models/ensemble_1_2_3/bootstrap_{0,1}.bin` and both
    reports."""
    jax_out, out = _both_dirs(tmp_path)
    argv = ["--no-padded_compile", "--max_configs", "4", "--num_rep", "2", *ENSEMBLE]
    ref_val, ref_test = jax_ens_boot.main([*argv, *_paths(synth_root, jax_out,
                                                          "fixed_split")])
    val, test = ens_boot_driver.main([*argv, "--device", "cpu",
                                      *_paths(synth_root, out, "fixed_split")])
    assert not jax_inits
    assert list(val) == list(test) == ["1_2_3"]
    for rep in ("boot0", "boot1"):
        _close(val["1_2_3"][rep], _float_metrics(ref_val["1_2_3"][rep]), f"val {rep}")
        _close(test["1_2_3"][rep], _float_metrics(ref_test["1_2_3"][rep]),
               f"test {rep}")
    for rep in (0, 1):
        assert (out / "bootstrap_ensemble_models" / "ensemble_1_2_3"
                / f"bootstrap_{rep}.bin").exists()
    for name in ("Ensemble_Bootstrap", "Ensemble_Bootstrap_test"):
        assert (out / f"{name}.csv").exists() and (out / f"{name}.xlsx").exists()
