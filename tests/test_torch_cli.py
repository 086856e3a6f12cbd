"""The port's baseline drivers against the JAX package's, on the CPU.

Both run in-process through `main(argv)` on `tests/test_cli.py`'s synthetic
dataset (`__graft_entry__._synth_dataset`: 8 patients of 12 PIL-written
PNGs at 32 px, two CV folds and the fixed split), with dropout 0 in both
packages' configs (as `tests/test_torch_train.py` runs the trainers), the
port started from the weights the JAX run drew (its `init_baseline` and
`init_group_params` patched to convert them).  Each test names its
tolerance; the drivers' metrics are held to 1e-4.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax

from vit3d_ensemble_tpu.cli import test_cv as jax_test_cv
from vit3d_ensemble_tpu.cli import train_baseline_cv as jax_cv
from vit3d_ensemble_tpu.cli import train_baseline_whole_dataset as jax_whole
from vit3d_ensemble_tpu.configs import ViTConfig as JaxViTConfig
from vit3d_ensemble_tpu.sweep import engine as jax_engine
from vit3d_ensemble_tpu.sweep import stack as jax_stack
from vit3d_ensemble_tpu.train import trainer as jax_trainer
from vit3d_ensemble_tpu_torch.checkpoint import vit_state_from_flax
from vit3d_ensemble_tpu_torch.cli import _common
from vit3d_ensemble_tpu_torch.cli import test_cv as test_cv_driver
from vit3d_ensemble_tpu_torch.cli import train_baseline_cv as cv_driver
from vit3d_ensemble_tpu_torch.cli import train_baseline_whole_dataset as whole_driver
from vit3d_ensemble_tpu_torch.configs import ViTConfig
from vit3d_ensemble_tpu_torch.models import VisionTransformer3D
from vit3d_ensemble_tpu_torch.ops import attention, mlp, quant
from vit3d_ensemble_tpu_torch.sweep import engine
from vit3d_ensemble_tpu_torch.train import trainer

from test_torch_sweep import _stacked_state

IMG = 32
#: Drivers' metrics, port against JAX, dropout 0.
METRICS_ATOL = 1e-4
#: The port's flags whose default or choices differ from the JAX drivers',
#: on purpose (`cli/_common.py`).
DIFFERENT = {"--device": ("cuda", None), "--mlp_impl": ("auto", "xla")}
HYPER = ["--num_steps", "4", "--eval_every", "2", "--warmup_steps", "2",
         "--learning_rate", "0.05", "--img_size", str(IMG)]


@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    from __graft_entry__ import _synth_dataset

    root = tmp_path_factory.mktemp("torch_cli_data")
    _synth_dataset(str(root), img=IMG, num_cv=2, fixed_split=True)
    return root


def _paths(root, out, csv_sub):
    return ["--csv_path", str(root / "csv_files" / csv_sub),
            "--data_root", str(root / "dataset"), "--output_dir", str(out)]


@pytest.fixture(autouse=True)
def _restore_impls():
    yield
    attention.set_default_attention_impl("auto")
    mlp.set_default_mlp_impl("auto")


# --- flags ----------------------------------------------------------------------


def _options(parser):
    return {a.option_strings[0]: a for a in parser._actions if a.option_strings}


@pytest.mark.parametrize("ours,ref", [(cv_driver, jax_cv), (whole_driver, jax_whole),
                                      (test_cv_driver, jax_test_cv)],
                         ids=["train_baseline_cv", "train_baseline_whole_dataset",
                              "test_cv"])
def test_parsers_take_the_jax_flags_and_defaults(ours, ref):
    """Every flag of the JAX driver, under the same names and dest, with the
    same default, type and action, but for those listed in DIFFERENT and
    the impl selectors' choices."""
    mine, theirs = _options(ours.build_parser()), _options(ref.build_parser())
    assert set(mine) == set(theirs)
    for flag, ref_action in theirs.items():
        action = mine[flag]
        assert action.option_strings == ref_action.option_strings, flag
        assert (action.dest, action.type, type(action)) == (
            ref_action.dest, ref_action.type, type(ref_action)), flag
        if flag in DIFFERENT:
            assert (action.default, ref_action.default) == DIFFERENT[flag]
        else:
            assert action.default == ref_action.default, flag
        if flag not in ("--attention_impl", "--mlp_impl"):
            assert action.choices == ref_action.choices, flag
    assert set(theirs["--attention_impl"].choices) < set(mine["--attention_impl"].choices)
    assert set(theirs["--mlp_impl"].choices) < set(mine["--mlp_impl"].choices)


@pytest.mark.parametrize("flag,value,impl", [
    ("--attention_impl", "xla", "plain"), ("--attention_impl", "vpu", "plain"),
    ("--attention_impl", "pallas", "kernel"), ("--attention_impl", "layer", "layer"),
    ("--attention_impl", "auto", "auto"), ("--mlp_impl", "xla", "plain"),
    ("--mlp_impl", "pallas", "kernel"), ("--mlp_impl", "auto", "auto"),
])
def test_impl_flags_take_jax_spellings(flag, value, impl):
    args = cv_driver.build_parser().parse_args([flag, value, "--device", "cpu"])
    _common.apply_runtime_flags(args)
    selected = (attention.get_default_attention_impl() if "attention" in flag
                else mlp.get_default_mlp_impl())
    assert selected == impl == getattr(args, flag[2:])


@pytest.mark.parametrize("argv,item", [
    (["--mesh", "2x4"], "parallel/mesh.py"),
    (["--remat"], "remat"),
])
def test_unported_flags_raise(argv, item, synth_root, tmp_path):
    """Both flags run since their ROADMAP.md items were ported: `--mesh 2x4`
    in a process alone raises the ValueError that names the torchrun
    command it needs (`parallel/mesh.py`; tests/test_torch_parallel.py
    runs the mesh), and `--remat` gives the grouped sweep's results without
    it, dropout on."""
    common = ["--all_configs", "--num_cv", "2", *HYPER, "--device", "cpu"]
    if item == "parallel/mesh.py":
        with pytest.raises(ValueError, match="torchrun --standalone --nproc_per_node=8"):
            cv_driver.main([*argv, *common, *_paths(synth_root, tmp_path, "cross_validation")])
        return
    # one intra-op thread: the stacked runs' many small ops slow down far
    # more than they gain under xdist's workers with every core each
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        on = cv_driver.main([*argv, *common, *_paths(synth_root, tmp_path / "on",
                                                     "cross_validation")])
        off = cv_driver.main([*common, *_paths(synth_root, tmp_path / "off",
                                               "cross_validation")])
    finally:
        torch.set_num_threads(threads)
    assert sorted(on) == list(range(1, 19)) and on == off


@pytest.mark.parametrize("driver", [cv_driver, test_cv_driver])
@pytest.mark.parametrize("impl", ["int8", "int8_attn"])
def test_quant_impl_flag_plumbing(driver, impl):
    """--quant_impl reaches the port's selector through apply_runtime_flags,
    and the next driver's defaults reset it to 'none' (JAX's
    `tests/test_cli.py::test_quant_impl_flag_plumbing`)."""
    try:
        _common.apply_runtime_flags(driver.build_parser().parse_args(
            ["--quant_impl", impl, "--device", "cpu"]))
        assert quant.get_default_quant_impl() == impl
        _common.apply_runtime_flags(driver.build_parser().parse_args(
            ["--device", "cpu"]))
        assert quant.get_default_quant_impl() == "none"
    finally:
        quant.set_default_quant_impl("none")


@pytest.mark.parametrize("driver", [cv_driver, whole_driver])
def test_drivers_need_a_card_unless_given_cpu(driver, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        driver.main(["--output_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        driver.main(["--all_configs", "--output_dir", str(tmp_path)])


def test_debug_nans_turns_on_anomaly_detection():
    args = cv_driver.build_parser().parse_args(["--debug_nans", "--device", "cpu"])
    try:
        _common.apply_runtime_flags(args)
        assert torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(False)


# --- the drivers against JAX's ------------------------------------------------------


@pytest.fixture()
def no_dropout(monkeypatch):
    """Both packages' configs at dropout 0; the port's inits taken from the
    JAX run's (recorded by wrapping JAX's)."""
    for cls in (JaxViTConfig, ViTConfig):
        real = cls.from_conf
        monkeypatch.setattr(cls, "from_conf", classmethod(
            lambda c, conf, img_size=128, _real=real, **kw: _real(
                conf, img_size=img_size, **{**kw, "dropout_rate": 0.0})))
    real_template = jax_stack.ConfigGroup.template_config
    monkeypatch.setattr(jax_stack.ConfigGroup, "template_config",
                        lambda self, img_size=128: dataclasses.replace(
                            real_template(self, img_size), dropout_rate=0.0))
    real_groups = engine.group_configs
    monkeypatch.setattr(engine, "group_configs", lambda confs: [
        dataclasses.replace(g, dropout_rate=0.0) for g in real_groups(confs)])

    inits = {"baseline": [], "group": {}}
    real_init = jax_trainer.init_baseline

    def record_init(config, seed, zero_head=True):
        model, params = real_init(config, seed, zero_head)
        inits["baseline"].append(jax.device_get(params))
        return model, params

    real_group_init = jax_engine.init_group_params

    def record_group_init(group, n_folds, seed, img_size=128):
        params = real_group_init(group, n_folds, seed, img_size)
        inits["group"][group.confs] = jax.device_get(params)
        return params

    monkeypatch.setattr(jax_trainer, "init_baseline", record_init)
    monkeypatch.setattr(jax_engine, "init_group_params", record_group_init)

    def port_init(config, seed, zero_head=True, device=None):
        model = VisionTransformer3D(config, vis=False, device=device)
        model.load_state_dict(vit_state_from_flax(inits["baseline"].pop(0), config))
        return model

    def port_group_init(group, n_folds, seed, img_size=128, device=None):
        params = jax.tree.map(lambda a: np.asarray(a)[:, :n_folds],
                              inits["group"][group.confs])
        return {k: v.to(device) for k, v in _stacked_state(
            params, group.template_config(img_size),
            (len(group.confs), n_folds)).items()}

    monkeypatch.setattr(trainer, "init_baseline", port_init)
    monkeypatch.setattr(engine, "init_group_params", port_group_init)
    return inits


def _close(ours, ref, where=""):
    assert list(ours) == list(ref), where
    for k in ref:
        np.testing.assert_allclose(ours[k], ref[k], atol=METRICS_ATOL, rtol=0,
                                   err_msg=f"{where} {k}")


def _checkpoint_shapes(path, conf):
    want = VisionTransformer3D(ViTConfig.from_conf(conf, img_size=IMG),
                               device="cpu").state_dict()
    got = torch.load(path, weights_only=True)
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in want.items()}


def test_train_baseline_cv_single_matches_jax(synth_root, tmp_path, no_dropout):
    """conf 9, two folds: every fold's 15 metrics (the 11 and CSP, CSE,
    BSNC, BSPC) within 1e-4 of the JAX driver's (measured: equal);
    checkpoints `cv_baseline_models/conf9/cv{1,2}.bin`."""
    argv = ["--config", "9", "--num_cv", "2", *HYPER]
    ref = jax_cv.main([*argv, *_paths(synth_root, tmp_path / "jax",
                                      "cross_validation")])
    out = tmp_path / "port"
    ours = cv_driver.main([*argv, "--device", "cpu",
                           *_paths(synth_root, out, "cross_validation")])
    assert list(ours) == ["CV 1", "CV 2"]
    for fold in ref:
        _close(ours[fold], ref[fold], fold)
    for f in (1, 2):
        _checkpoint_shapes(out / "cv_baseline_models" / "conf9" / f"cv{f}.bin", 9)
    assert '"event": "best_eval"' in (out / "metrics.jsonl").read_text()


def test_train_baseline_cv_all_configs_matches_jax(synth_root, tmp_path,
                                                   no_dropout, monkeypatch):
    """The 18 x 2 sweep from the pooled folds: every cell's metrics within
    1e-4 of the JAX driver's (measured: 1.8e-7), a checkpoint a (conf,
    fold) in the reference layout with the member's shapes, JAX's marker
    names; `--resume` then returns the same results without training."""
    argv = ["--all_configs", "--num_cv", "2", *HYPER]
    ref = jax_cv.main([*argv, *_paths(synth_root, tmp_path / "jax",
                                      "cross_validation")])
    out = tmp_path / "port"
    port_argv = [*argv, "--device", "cpu",
                 *_paths(synth_root, out, "cross_validation")]
    ours = cv_driver.main(port_argv)
    assert sorted(ours) == sorted(ref) == list(range(1, 19))
    for conf in ref:
        for fold in ref[conf]:
            _close(ours[conf][fold], ref[conf][fold], f"conf {conf} {fold}")
    for conf in range(1, 19):
        for f in (1, 2):
            path = out / "cv_baseline_models" / f"conf{conf}" / f"cv{f}.bin"
            assert path.exists(), path
    for conf in (1, 9, 18):
        _checkpoint_shapes(out / "cv_baseline_models" / f"conf{conf}" / "cv2.bin", conf)
    assert sorted(os.listdir(out / "sweep_state")) == sorted(
        os.listdir(tmp_path / "jax" / "sweep_state"))

    def must_not_train(*a, **k):
        raise AssertionError("a completed group trained again")

    monkeypatch.setattr(engine, "run_group", must_not_train)
    assert cv_driver.main([*port_argv, "--resume"]) == ours
    with open(out / "sweep_state" / sorted(os.listdir(out / "sweep_state"))[0]) as f:
        assert set(json.load(f)) <= {str(c) for c in range(1, 19)}


def test_train_baseline_whole_dataset_matches_jax(synth_root, tmp_path, no_dropout):
    """conf 5 on the fixed split, unweighted loss: the best metrics within
    1e-4 of the JAX driver's (measured: 1.1e-6);
    `baseline_models/conf5/conf5.bin`."""
    argv = ["--config", "5", *HYPER]
    ref = jax_whole.main([*argv, *_paths(synth_root, tmp_path / "jax", "fixed_split")])
    out = tmp_path / "port"
    ours = whole_driver.main([*argv, "--device", "cpu",
                              *_paths(synth_root, out, "fixed_split")])
    assert list(ours) == [5]
    _close(ours[5], ref[5], "conf 5")
    _checkpoint_shapes(out / "baseline_models" / "conf5" / "conf5.bin", 5)


def test_train_baseline_whole_dataset_all_configs(synth_root, tmp_path):
    """`--all_configs` on the fixed split with device augmentation, dropout
    on: 18 finite results, one checkpoint a conf, 'whole' markers."""
    out = tmp_path / "port"
    res = whole_driver.main(["--all_configs", "--aug_mode", "device", *HYPER,
                             "--device", "cpu", *_paths(synth_root, out, "fixed_split")])
    assert sorted(res) == list(range(1, 19))
    assert all(np.isfinite(v) for m in res.values() for v in m.values())
    for conf in range(1, 19):
        assert (out / "baseline_models" / f"conf{conf}" / f"conf{conf}.bin").exists()
    assert all(n.startswith("whole_group_") for n in os.listdir(out / "sweep_state"))
