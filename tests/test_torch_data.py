"""The port's data layer and host metrics against the JAX package's, on the
CPU.

The dataset is `chip_smoke.synth_dataset` at 16 px: 12 patients (one of
them ProstateX-0179, whose slices are not reversed) of 18-25 slices, the
four folders, a third of the lesions HG, with rows at z0 = 1 and at the
last slice, where the 5-slice window runs off either end.  Its PNGs are
written with every row filter type in turn; a few more are written by PIL,
which picks filters adaptively.  The JAX side reads them with pandas and
its native decoder (PIL where that fails).  Each test names its tolerance:
element equality for the loaders, decoders, pools, means and bootstrap
rows; at most 0.1 % of a volume's pixels for rotations (a source
coordinate at an exact .5 may round the other way); 1e-12 for the metrics.
"""

import dataclasses
import os
import pathlib
import random
import subprocess
import sys
import zlib

import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

import chip_smoke
from vit3d_ensemble_tpu.data import augment as jax_augment
from vit3d_ensemble_tpu.data import pipeline as jax_pipeline
from vit3d_ensemble_tpu.data import pool as jax_pool
from vit3d_ensemble_tpu.data import volumes as jax_volumes
from vit3d_ensemble_tpu.metrics import host as jax_host
from vit3d_ensemble_tpu.utils import seed as jax_seed
from vit3d_ensemble_tpu_torch.data import augment, native_loader, pipeline, pool, volumes
from vit3d_ensemble_tpu_torch.data.png import decode_gray8
from vit3d_ensemble_tpu_torch.metrics import host
from vit3d_ensemble_tpu_torch.utils import debug, seed

REPO = pathlib.Path(__file__).resolve().parents[1]
IMG = 16
FOLDS = 2
#: Rotated volumes: at most this share of pixels may differ.
ROTATION_MAX_SHARE = 1e-3


@pytest.fixture(scope="module")
def ds(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_data")
    info = chip_smoke.synth_dataset(root, img=IMG, patients=12, rows=30,
                                    test=6, folds=FOLDS, fixed_val=4, seed=3)
    info["train_csv"] = os.path.join(info["fixed_csv"], "training.csv")
    info["val_csv"] = os.path.join(info["fixed_csv"], "validation.csv")
    info["cv1"] = [os.path.join(info["cv_csv"], f"{k}_cv1.csv")
                   for k in ("training", "validation")]
    return info


def _all_rows(ds):
    rows = set()
    for name in os.listdir(ds["cv_csv"]):
        rows |= {(r.Patient, r.z0) for r in
                 pd.read_csv(os.path.join(ds["cv_csv"], name)).itertuples()}
    return sorted(rows)


def _rotation_share(a, b) -> float:
    """The largest share of differing pixels over the volumes of a batch."""
    a, b = np.asarray(a), np.asarray(b)
    return float((a != b).reshape(len(a), -1).mean(axis=1).max())


# --- manifests ----------------------------------------------------------------


def test_manifest_matches_pandas(tmp_path, ds):
    """Columns, values and Python types as `pd.read_csv(...).itertuples()`
    gives them: the dataset's manifests, and one with a float column,
    missing fields and an integer column with a missing field (read as
    floats)."""
    odd = tmp_path / "odd.csv"
    odd.write_text("Patient,Label,Score,Note,GG,z0,Lesion\n"
                   "ProstateX-0001,HG,0.5,a,3,3,1\n"
                   "ProstateX-0002,LG,,,,07,2\n"
                   "ProstateX-0003,LG,2,NA,1,-4,3\n\n")
    paths = [str(odd), ds["train_csv"], *ds["cv1"],
             os.path.join(ds["cv_csv"], "test.csv")]
    for path in paths:
        ref = pd.read_csv(path)
        ours = volumes.load_manifest(path)
        assert ours.columns == tuple(ref.columns)
        assert len(ours) == len(ref)
        for a, b in zip(ours.rows(), ref.itertuples(index=False)):
            assert [type(v) for v in a] == [type(v) for v in b], path
            assert repr(tuple(a)) == repr(tuple(b)), path
        for c in ref.columns:
            assert repr(ours[c]) == repr(ref[c].tolist())
    picked = volumes.load_manifest(ds["train_csv"]).take([4, 0, 4])
    ref = pd.read_csv(ds["train_csv"]).iloc[[4, 0, 4]]
    assert [tuple(r) for r in picked.rows()] == [
        tuple(r) for r in ref.itertuples(index=False)]


# --- volumes ------------------------------------------------------------------


def test_dataset_covers_the_edge_cases(ds):
    """The rows below are what the volume tests hold: ProstateX-0179 at both
    ends of its stack, and reversed patients whose windows run off either
    end (trailing zero slices)."""
    rows = _all_rows(ds)
    assert {p for p, _ in rows} >= {"ProstateX-0179"}
    ends = {z0 for p, z0 in rows if p == "ProstateX-0179"}
    n179 = len(os.listdir(os.path.join(ds["data_root"], "ProstateX-0179",
                                       "original")))
    assert {1, n179} <= ends
    zeros = [volumes.load_volume(ds["data_root"], p, z0, size=IMG)[..., 4, 0]
             for p, z0 in rows]
    assert sum(not z.any() for z in zeros) >= 2


@pytest.mark.parametrize("folder", ["original", "rotation", "vertical_flip",
                                    "horizontal_flip"])
def test_load_volume_matches_jax(ds, folder):
    """Element-equal for every (patient, z0) of the manifests."""
    for patient, z0 in _all_rows(ds):
        ours = volumes.load_volume(ds["data_root"], patient, z0, folder, IMG)
        ref = jax_volumes.load_volume(ds["data_root"], patient, z0, folder, IMG)
        assert ours.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(ours, ref, err_msg=f"{patient} {z0}")


@pytest.mark.parametrize("ood", [False, True])
def test_load_split_matches_jax(ds, ood):
    """Element-equal, OOD noise included (the same numpy stream)."""
    for path in (ds["train_csv"], *ds["cv1"]):
        ours = volumes.load_split(path, ds["data_root"], size=IMG, ood=ood,
                                  ood_mean=0.5, ood_var=2.0, ood_seed=7)
        ref = jax_volumes.load_split(path, ds["data_root"], size=IMG, ood=ood,
                                     ood_mean=0.5, ood_var=2.0, ood_seed=7)
        np.testing.assert_array_equal(ours.volumes, ref.volumes)
        np.testing.assert_array_equal(ours.labels, ref.labels)
        assert (ours.patients, ours.zones) == (ref.patients, ref.zones)


def test_npy_slices_and_foreign_files(tmp_path):
    """`.npy` slices go through np.load as in the JAX package; a file that
    is neither PNG nor .npy raises, naming it, where JAX would try PIL."""
    folder = tmp_path / "P-npy" / "original"
    folder.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for j in range(1, 8):
        np.save(folder / f"1-{j:02d}.npy", rng.integers(0, 255, (IMG, IMG),
                                                          dtype=np.uint8))
    for z0 in (1, 4, 7):
        np.testing.assert_array_equal(
            volumes.load_volume(str(tmp_path), "P-npy", z0, size=IMG),
            jax_volumes.load_volume(str(tmp_path), "P-npy", z0, size=IMG))
    other = tmp_path / "P-odd" / "original"
    other.mkdir(parents=True)
    (other / "1-01.jpg").write_bytes(b"not an image")
    with pytest.raises(ValueError, match="1-01.jpg"):
        volumes.load_volume(str(tmp_path), "P-odd", 1, size=IMG)


# --- PNG decoders -------------------------------------------------------------


def _png_files(ds, patients=4):
    names = sorted(os.listdir(ds["data_root"]))[:patients]
    return [os.path.join(ds["data_root"], p, f, s) for p in names
            for f in sorted(os.listdir(os.path.join(ds["data_root"], p)))
            for s in sorted(os.listdir(os.path.join(ds["data_root"], p, f)))]


def _filter_types(path) -> set:
    """The row filter types of a non-interlaced 8-bit grayscale PNG."""
    data = pathlib.Path(path).read_bytes()
    pos, idat, width = 8, b"", None
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            width = int.from_bytes(body[:4], "big")
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    raw = zlib.decompress(idat)
    return set(raw[::width + 1])


@pytest.fixture(scope="module")
def pil_pngs(tmp_path_factory):
    """PNGs written by PIL (adaptive filters) at two sizes."""
    root = tmp_path_factory.mktemp("pil_png")
    rng = np.random.default_rng(5)
    paths = []
    for i, size in enumerate((IMG, IMG, 24, 24, 128)):
        img = (np.add.outer(np.arange(size), np.arange(size)) * 3 % 256
               + rng.integers(0, 40, (size, size))).clip(0, 255).astype(np.uint8)
        paths.append(str(root / f"pil_{i}.png"))
        Image.fromarray(img).save(paths[-1])
    return paths


@pytest.mark.parametrize("decoder", ["native", "zlib"])
def test_decoders_match_pil(ds, pil_pngs, decoder):
    """Both decoders equal PIL's decode, element for element, on the
    dataset's PNGs (every filter type in turn) and on PIL's own."""
    files = _png_files(ds)
    assert set().union(*map(_filter_types, files[:3])) == {0, 1, 2, 3, 4}
    assert len(set().union(*map(_filter_types, pil_pngs))) >= 2
    for group in (files, pil_pngs[:2], pil_pngs[2:4], pil_pngs[4:]):
        ref = np.stack([np.asarray(Image.open(p)) for p in group])
        if decoder == "native":
            ours = native_loader.decode_batch(group, ref.shape[-1])
        else:
            ours = np.stack([decode_gray8(p) for p in group])
        assert ours is not None
        np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("kind", ["rgb", "16bit", "palette", "interlaced"])
def test_zlib_decoder_rejects_other_formats(tmp_path, kind):
    path = str(tmp_path / f"{kind}.png")
    img = np.arange(64, dtype=np.uint8).reshape(8, 8)
    if kind == "interlaced":
        chip_smoke.write_png(path, img, interlace=1)
    else:
        mode = {"rgb": "RGB", "16bit": "I;16", "palette": "P"}[kind]
        Image.fromarray(img).convert(mode).save(path)
    with pytest.raises(ValueError, match=f"{kind}.png"):
        decode_gray8(path)


def test_native_library_build_and_fallback(ds, monkeypatch):
    """The unedited `native/volume_loader.cpp` builds into the checkout's
    `build/native/` (never `native/`), ABI 1; with it disabled, the stdlib
    decoder gives the same stacks."""
    lib = native_loader.load_library()
    assert lib is not None and lib.v3d_version() == 1
    path = native_loader.library_path()
    assert path.parent == REPO / "build" / "native" and path.exists()
    assert native_loader.status() == {"decoder": "native",
                                      "library": str(path), "reason": None}
    folder = os.path.join(ds["data_root"], "ProstateX-0179", "original")
    names = sorted(os.listdir(folder))
    native = native_loader.decode_batch([os.path.join(folder, n) for n in names], IMG)
    monkeypatch.setenv("VIT3D_NATIVE", "0")
    native_loader.load_library.cache_clear()
    volumes.clear_volume_cache()
    try:
        assert native_loader.decoder() == "zlib"
        assert "VIT3D_NATIVE" in native_loader.status()["reason"]
        stack, got = volumes._patient_stack(ds["data_root"], "ProstateX-0179",
                                            "original", IMG)
        assert got == tuple(names)
        np.testing.assert_array_equal(stack, native)
        with pytest.raises(ValueError, match="expected"):
            volumes._patient_stack(ds["data_root"], "ProstateX-0179",
                                   "original", IMG + 1)
    finally:
        monkeypatch.delenv("VIT3D_NATIVE")
        native_loader.load_library.cache_clear()
        volumes.clear_volume_cache()
    assert native_loader.decoder() == "native"


# --- augmentation -------------------------------------------------------------


def _volumes(n, size=32, seed=0):
    return np.random.default_rng(seed).normal(
        size=(n, size, size, 5, 1)).astype(np.float32)


def test_flips_match_jax():
    vols = _volumes(3)
    for ours, ref in ((augment.vertical_flip, jax_augment.vertical_flip),
                      (augment.horizontal_flip, jax_augment.horizontal_flip)):
        np.testing.assert_array_equal(ours(torch.from_numpy(vols)).numpy(),
                                      np.asarray(ref(vols)))
        np.testing.assert_array_equal(ours(torch.from_numpy(vols[0])).numpy(),
                                      np.asarray(ref(vols[0])))


ANGLES = (-30.0, -17.3, -0.5, 0.0, 12.25, 29.99, 45.0, 90.0, 180.0)


def test_rotate_inplane_matches_jax():
    """Fixed angles, batched and one volume at a time, at two sizes: at most
    0.1 % of a volume's pixels differ from JAX's."""
    for size in (32, 17):
        vols = _volumes(len(ANGLES), size, seed=size)
        ref = np.asarray(jax.jit(jax.vmap(jax_augment.rotate_inplane))(
            vols, jnp.asarray(ANGLES, jnp.float32)))
        ours = augment.rotate_inplane(torch.from_numpy(vols),
                                      torch.tensor(ANGLES)).numpy()
        assert _rotation_share(ours, ref) <= ROTATION_MAX_SHARE
        one = augment.rotate_inplane(torch.from_numpy(vols[4]), ANGLES[4]).numpy()
        np.testing.assert_array_equal(one, ours[4])
    # 0 degrees is the identity, 180 the two flips
    np.testing.assert_array_equal(ours[3], vols[3])
    np.testing.assert_array_equal(ours[8], vols[8][::-1, ::-1])


def test_augment_batch_order_and_angles():
    vols = torch.from_numpy(_volumes(4))
    out = augment.augment_batch(vols, torch.Generator().manual_seed(9))
    angles = torch.rand(4, generator=torch.Generator().manual_seed(9)) * 60 - 30
    assert out.shape == (3, *vols.shape)
    np.testing.assert_array_equal(out[0], augment.rotate_inplane(vols, angles))
    np.testing.assert_array_equal(out[1], augment.vertical_flip(vols))
    np.testing.assert_array_equal(out[2], augment.horizontal_flip(vols))


# --- splits -------------------------------------------------------------------


@pytest.mark.parametrize("aug_mode", ["disk", "none"])
def test_build_train_val_matches_jax(ds, aug_mode):
    """Element-equal splits; the mean to the bit."""
    for train_csv, val_csv in ((ds["train_csv"], ds["val_csv"]), ds["cv1"]):
        ours = pipeline.build_train_val(train_csv, val_csv, ds["data_root"],
                                        aug_mode=aug_mode, size=IMG)
        ref = jax_pipeline.build_train_val(train_csv, val_csv, ds["data_root"],
                                           aug_mode=aug_mode, size=IMG)
        assert ours[2] == ref[2]
        for a, b in zip(ours[:2], ref[:2]):
            np.testing.assert_array_equal(a.volumes, b.volumes)
            np.testing.assert_array_equal(a.labels, b.labels)
            assert (a.patients, a.zones) == (b.patients, b.zones)


def test_build_train_val_device_augmentation(ds):
    """'device' on the CPU: the split, the mean and the flipped rows equal
    JAX's; the rotated rows equal JAX's rotation at the angles the port drew
    (the two packages' random streams differ), within 0.1 % of pixels."""
    train, val, mean = pipeline.build_train_val(*ds["cv1"], ds["data_root"],
                                                aug_mode="device", size=IMG,
                                                aug_seed=4, device="cpu")
    base, ref_val, ref_mean = jax_pipeline.build_train_val(
        *ds["cv1"], ds["data_root"], aug_mode="none", size=IMG)
    assert mean == ref_mean
    np.testing.assert_array_equal(val.volumes, ref_val.volumes)
    n = len(base)
    src = base.subset(np.flatnonzero(base.labels == 1)[::3])
    k = len(src)
    assert len(train) == n + 3 * k
    np.testing.assert_array_equal(train.volumes[:n], base.volumes)
    angles = torch.rand(k, generator=torch.Generator().manual_seed(4)) * 60 - 30
    raw = src.volumes + np.float32(mean)
    rotated = np.asarray(jax.jit(jax.vmap(jax_augment.rotate_inplane))(
        raw, jnp.asarray(angles.numpy()))) - np.float32(mean)
    assert _rotation_share(train.volumes[n:n + k], rotated) <= ROTATION_MAX_SHARE
    np.testing.assert_array_equal(train.volumes[n + k:n + 2 * k], src.volumes[:, ::-1])
    np.testing.assert_array_equal(train.volumes[n + 2 * k:], src.volumes[:, :, ::-1])
    np.testing.assert_array_equal(train.labels[n:], np.tile(src.labels, 3))


def test_bootstrap_resample_matches_pandas(ds):
    """The rows of `df.sample(n, replace=True, random_state=seed)`, in order,
    for seeds 0-99."""
    ours_base = volumes.load_manifest(ds["train_csv"])
    ref_base = pd.read_csv(ds["train_csv"])
    for s in range(100):
        ours = pipeline.bootstrap_resample(ours_base, s)
        ref = jax_pipeline.bootstrap_resample(ref_base, s)
        assert [tuple(r) for r in ours.rows()] == [
            tuple(r) for r in ref.itertuples(index=False)], s
    assert len(pipeline.bootstrap_resample(ds["train_csv"], 0)) == len(ref_base)


# --- pools --------------------------------------------------------------------


def _build_pools(ds, kind, aug_mode):
    if kind == "cv":
        args = (ds["cv_csv"], ds["data_root"], FOLDS)
        return (pool.build_pooled_cv(*args, size=IMG, aug_mode=aug_mode,
                                     device="cpu"),
                jax_pool.build_pooled_cv(*args, size=IMG, aug_mode=aug_mode))
    args = (ds["train_csv"], ds["val_csv"], ds["data_root"])
    if kind == "fixed":
        return (pool.build_pooled_fixed(*args, size=IMG, aug_mode=aug_mode,
                                        device="cpu"),
                jax_pool.build_pooled_fixed(*args, size=IMG, aug_mode=aug_mode))
    return (pool.build_pooled_bootstrap(*args, 3, size=IMG, aug_mode=aug_mode,
                                        seed0=5, device="cpu"),
            jax_pool.build_pooled_bootstrap(*args, 3, size=IMG,
                                            aug_mode=aug_mode, seed0=5))


@pytest.mark.parametrize("aug_mode", ["disk", "device", "none"])
@pytest.mark.parametrize("kind", ["cv", "fixed", "bootstrap"])
def test_pools_match_jax(ds, kind, aug_mode):
    """Equal `key_to_row` (keys of the same Python types), `row_idx`,
    labels and means; volumes element-equal but for the device-rotation
    rows, each within 0.1 % of pixels."""
    (ours, ours_folds), (ref, ref_folds) = _build_pools(ds, kind, aug_mode)
    assert sorted(map(repr, ours.key_to_row.items())) == sorted(
        map(repr, ref.key_to_row.items()))
    np.testing.assert_array_equal(ours.row_means, ref.row_means)
    rot = sorted(r for k, r in ours.key_to_row.items() if k[3] == "device_rotation")
    assert bool(rot) == (aug_mode == "device")
    other = np.setdiff1d(np.arange(len(ours)), rot)
    np.testing.assert_array_equal(ours.volumes[other], ref.volumes[other])
    if rot:
        assert _rotation_share(ours.volumes[rot], ref.volumes[rot]) <= ROTATION_MAX_SHARE
    assert len(ours_folds) == len(ref_folds) == {"cv": FOLDS, "fixed": 1,
                                                  "bootstrap": 3}[kind]
    for (t, v), (rt, rv) in zip(ours_folds, ref_folds):
        for a, b in ((t, rt), (v, rv)):
            np.testing.assert_array_equal(a.row_idx, b.row_idx)
            np.testing.assert_array_equal(a.labels, b.labels)
            assert a.row_idx.dtype == np.int32 and a.mean == b.mean


def test_stable_angle_hashes_python_types():
    """The rotation angle is keyed on repr of (patient, z0, lesion): an int
    Lesion, as pandas and `Manifest` read it, gives JAX's angle; a string
    or float one would not."""
    key = ("ProstateX-0179", 5, 1)
    assert pool._stable_angle(42, key, -30, 30) == jax_pool._stable_angle(
        42, key, -30, 30)
    assert pool._stable_angle(42, key, -30, 30) != pool._stable_angle(
        42, ("ProstateX-0179", 5, "1"), -30, 30)
    assert pool._stable_angle(42, key, -30, 30) != pool._stable_angle(
        42, ("ProstateX-0179", 5, 1.0), -30, 30)


# --- host metrics -------------------------------------------------------------


def _metric_case(name):
    rng = np.random.default_rng(len(name))
    y = rng.integers(0, 2, 40)
    p = np.round(rng.uniform(size=40), 1)           # ties
    if name == "one_class_negative":
        y = np.zeros(12, int)
        p = p[:12]
    elif name == "one_class_positive":
        y = np.ones(12, int)
        p = p[:12]
    elif name == "all_predicted_positive":
        p = np.clip(p, 0.6, 1.0)
    elif name == "all_tied":
        p = np.full(40, 0.3)
    elif name == "continuous":
        p = rng.uniform(size=40)
    return y, (p > 0.5).astype(int), p


@pytest.mark.parametrize("name", ["ties", "one_class_negative",
                                  "one_class_positive", "all_predicted_positive",
                                  "all_tied", "continuous"])
def test_host_metrics_match_sklearn(name):
    """Within 1e-12 of the JAX package's sklearn metrics, NaN where sklearn
    gives NaN (AUROC of one class; a Brier restriction to an absent class)."""
    y, pred, p = _metric_case(name)
    ours, ref = host.eleven_metrics(y, pred, p), jax_host.eleven_metrics(y, pred, p)
    assert list(ours) == list(ref)
    for k in ref:
        np.testing.assert_allclose(ours[k], ref[k], atol=1e-12, rtol=0,
                                   equal_nan=True, err_msg=k)
    assert host.calculate_confidence_metrics(y, pred, p) == \
        jax_host.calculate_confidence_metrics(y, pred, p)
    for cl in (0, 1):
        np.testing.assert_allclose(host.brier_score_one_class(y, p, cl),
                                   jax_host.brier_score_one_class(y, p, cl),
                                   atol=1e-12, rtol=0, equal_nan=True)


# --- utils --------------------------------------------------------------------


def test_set_seed_seeds_the_host_sources_as_jax_does():
    gen = seed.set_seed(11)
    ours = (random.random(), np.random.rand())
    jax_seed.set_seed(11)
    assert ours == (random.random(), np.random.rand())
    assert isinstance(gen, torch.Generator) and gen.initial_seed() == 11


def test_nan_checking_toggles_anomaly_detection():
    try:
        debug.enable_nan_checking()
        assert torch.is_anomaly_enabled()
        x = torch.zeros(1, requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            (x * float("nan")).sqrt().sum().backward()
    finally:
        debug.disable_nan_checking()
    assert not torch.is_anomaly_enabled()


def test_data_and_cli_import_no_jax_pandas_pil_sklearn():
    """The modules of this slice load none of jax, the JAX package, pandas,
    sklearn or PIL, which the card's host lacks."""
    code = (
        "import sys\n"
        "import vit3d_ensemble_tpu_torch.data.pool, "
        "vit3d_ensemble_tpu_torch.data.png, "
        "vit3d_ensemble_tpu_torch.data.native_loader, "
        "vit3d_ensemble_tpu_torch.metrics.host, "
        "vit3d_ensemble_tpu_torch.utils.seed, "
        "vit3d_ensemble_tpu_torch.utils.debug, "
        "vit3d_ensemble_tpu_torch.cli.train_baseline_cv, "
        "vit3d_ensemble_tpu_torch.cli.train_baseline_whole_dataset\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'vit3d_ensemble_tpu', 'pandas', 'sklearn', "
        "'PIL'))\n"
        "print(repr(bad))\n")
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"
