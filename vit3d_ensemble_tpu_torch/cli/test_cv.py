"""Test/statistics driver — mirrors `test_cv.py` (reference), the port's
counterpart of `vit3d_ensemble_tpu/cli/test_cv.py`.

    python -m vit3d_ensemble_tpu_torch.cli.test_cv --baseline --ensemble \
        --conf 5 --ensemble_conf_list 5,9,11 --csv_path ... --data_root ...

Per CV fold: load the fold's trained checkpoint, evaluate it on the
held-out test split (normalized with that fold's training mean,
`test_cv.py:46-52`) in one forward on the device, compute the 11 metrics,
aggregate median/mean/percentile CIs, then run the cross-model statistics
(Shapiro-Wilk, Mood's median test, Mann-Whitney U) and save their plots
(`metrics/stats.py`).

`--ensemble` reads, in JAX's order: the end-to-end ensemble of each fold
(`cv_ensemble_models/ensemble_{name}/cv{k}.bin`, `train_ensemble_cv
--save_ensembles` or `--no-padded_compile`), else the frozen mode's
`meta_heads.bin` over the members' logits, else the held-out test metrics
in the grid's resume markers (`sweep_state/e2e_*.json`).

`--all_ensembles` ranks every trained C(18,3) combination on the test
split: from the grid's markers (unless `--ood`), else from every
`meta_heads.bin`, all (combination, fold) heads in one batched metrics
program on the device, and writes the ranking workbook
`Test_All_Ensembles.{xlsx,csv}`.

`--ood` adds Gaussian noise to the test volumes (`create_dataset.py:55-59`).

The port reads the `.bin` state dicts its own drivers (and the
reference's) write; it cannot read the JAX package's `.msgpack`
checkpoints, which need flax.  Runs on the CUDA device unless `--device
cpu`.

Reference defects repaired, as in the JAX driver (SURVEY.md D8): the
reference uses an undefined `testset`, returns from inside its
combination loop, and logs statistics even when only one of
--baseline/--ensemble is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import glob
import json
import logging
import os
from typing import Dict

import numpy as np
import torch

from vit3d_ensemble_tpu_torch.checkpoint import (
    baseline_ckpt_path,
    ensemble_ckpt_path,
    load_baseline_params,
    load_state_dict,
)
from vit3d_ensemble_tpu_torch.cli._common import (
    add_common_flags,
    apply_runtime_flags,
    parse_conf_list,
    setup_logging,
)
# the 11 metrics of a split's probabilities at threshold 0.5, as the grid's
# markers hold them
from vit3d_ensemble_tpu_torch.cli.train_ensemble_cv import held_out_metrics
from vit3d_ensemble_tpu_torch.configs import ViTConfig
from vit3d_ensemble_tpu_torch.data import load_split
from vit3d_ensemble_tpu_torch.metrics import (
    METRIC_KEYS,
    compute_eval_metrics,
    metrics_vector,
)
from vit3d_ensemble_tpu_torch.metrics.stats import aggregate_folds, compute_statistics

logger = logging.getLogger("test_cv")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    add_common_flags(parser, csv_subdir="cross_validation")
    parser.add_argument("--cv", type=int, default=5,
                        help="Number of folds in cross validation.")
    parser.add_argument("--conf", type=int, default=5,
                        help="Baseline configuration to test.")
    parser.add_argument("--ensemble_conf_list", default="5,9,11",
                        help="Ensemble combination to test.")
    parser.add_argument("--baseline", action="store_true",
                        help="Test the baseline model.")
    parser.add_argument("--ensemble", action="store_true",
                        help="Test the ensemble model.")
    parser.add_argument("--all_ensembles", action="store_true",
                        help="Evaluate EVERY trained C(18,3) meta-head "
                             "combination on the test split (one batched "
                             "program) and write the full ranking workbook.")
    parser.add_argument("--max_configs", type=int, default=19,
                        help="Max baseline configuration number + 1 "
                             "(for --all_ensembles).")
    parser.add_argument("--combinations", type=int, default=3,
                        help="Baselines per ensemble (for --all_ensembles).")
    parser.add_argument("--ood", action="store_true",
                        help="Gaussian-noise OOD test volumes "
                             "(create_dataset.py:55-59).")
    parser.add_argument("--ood_mean", type=float, default=0.0,
                        help="OOD noise mean.")
    parser.add_argument("--ood_var", type=float, default=1.0,
                        help="OOD noise std (the reference passes this to "
                             "np.random.normal's scale argument).")
    parser.add_argument("--test_batch_size", type=int, default=1,
                        help="(kept for CLI parity; eval is one forward)")
    parser.add_argument("--output_path", default=None,
                        help="Where to write plots (defaults to "
                             "--output_dir).")
    parser.add_argument("--base_path", default=None,
                        help="Directory holding the per-fold baseline "
                             "checkpoints (conf{c}/cv{k}.bin), overriding "
                             "output_dir/cv_baseline_models — the "
                             "reference's flag (test_cv.py:252-254).")
    parser.add_argument("--ens_path", default=None,
                        help="Directory holding the ensemble checkpoints "
                             "(ensemble_{a}_{b}_{c}/...), overriding "
                             "output_dir/cv_ensemble_models — the "
                             "reference's flag (test_cv.py:255-257).")
    return parser


def _cv_baseline_ckpt(args, conf: int, tag: str) -> str:
    if getattr(args, "base_path", None):
        return os.path.join(args.base_path, f"conf{conf}", f"{tag}.bin")
    return baseline_ckpt_path(args.output_dir, "cv_baseline", conf, tag)


def _cv_ensemble_ckpt(args, name: str, tag: str) -> str:
    if getattr(args, "ens_path", None):
        return os.path.join(args.ens_path, f"ensemble_{name}", f"{tag}.bin")
    return ensemble_ckpt_path(args.output_dir, "cv_ensemble", name, tag)


@functools.lru_cache(maxsize=16)
def _cached_split_impl(csv_file: str, csv_mtime: float, data_root: str,
                       size: int, ood: bool, ood_mean: float,
                       ood_var: float, ood_seed: int):
    return load_split(csv_file, data_root, size=size, ood=ood,
                      ood_mean=ood_mean, ood_var=ood_var, ood_seed=ood_seed)


def _cached_split(csv_file: str, data_root: str, size: int,
                  ood: bool = False, ood_mean: float = 0.0,
                  ood_var: float = 1.0, ood_seed: int = 0):
    """Split loads memoized for the process: test_baseline and
    test_ensemble walk the same folds, and every fold derives its
    normalization mean from the (heavily overlapping) training CSVs.  Keyed
    by the manifest's mtime, so a regenerated CSV is not served stale."""
    return _cached_split_impl(csv_file, os.path.getmtime(csv_file),
                              data_root, size, ood, ood_mean, ood_var,
                              ood_seed)


@functools.lru_cache(maxsize=16)
def _fold_train_mean_impl(csv_file: str, csv_mtime: float, data_root: str,
                          size: int) -> float:
    train = _cached_split(csv_file, data_root, size)
    return float(np.mean(train.volumes, dtype=np.float64))


def _fold_train_mean(csv_file: str, data_root: str, size: int) -> float:
    return _fold_train_mean_impl(csv_file, os.path.getmtime(csv_file),
                                 data_root, size)


def _fold_test_split(args, cv: int):
    """Test split normalized by fold cv's training mean (`test_cv.py:46-52`)."""
    mean = _fold_train_mean(
        os.path.join(args.csv_path, f"training_cv{cv + 1}.csv"),
        args.data_root, args.img_size)
    test = _cached_split(
        os.path.join(args.csv_path, "test.csv"), args.data_root,
        args.img_size, ood=bool(getattr(args, "ood", False)),
        ood_mean=getattr(args, "ood_mean", 0.0),
        ood_var=getattr(args, "ood_var", 1.0), ood_seed=args.seed)
    return dataclasses.replace(test, volumes=test.volumes - np.float32(mean))


def _log_aggregate(tag: str, res: Dict[str, Dict[str, float]]):
    agg = aggregate_folds(res)
    logger.info("---%s results (median and 95%% CI)---", tag)
    for k, s in agg.items():
        logger.info("%s: %.3f [%.3f-%.3f]", k, s["median"], s["p2.5"],
                    s["p97.5"])
    return agg


def test_baseline(args) -> Dict[str, Dict[str, float]]:
    """Each fold's `cv{k}.bin` of --conf on the normalized test split, in
    one forward on the device (K1 and K2 on a card)."""
    from vit3d_ensemble_tpu_torch.models import VisionTransformer3D
    from vit3d_ensemble_tpu_torch.train.steps import baseline_eval_step

    cfg = ViTConfig.from_conf(args.conf, img_size=args.img_size)
    model = VisionTransformer3D(cfg, zero_head=False, vis=False,
                                device=args.device)
    model.eval()
    res: Dict[str, Dict[str, float]] = {}
    for cv in range(args.cv):
        path = _cv_baseline_ckpt(args, args.conf, f"cv{cv + 1}")
        model.load_state_dict(load_baseline_params(path, cfg))
        test = _fold_test_split(args, cv)
        probs, _ = baseline_eval_step(
            model, torch.as_tensor(test.volumes, device=args.device))
        res[f"CV {cv + 1}"] = held_out_metrics(test.labels, probs.cpu().numpy())
    _log_aggregate("Base ViT", res)
    return res


def _members(args, confs, configs):
    """The whole-dataset baselines `baseline_models/conf{c}/conf{c}.bin`
    under --output_dir, by conf."""
    return {c: load_baseline_params(
        baseline_ckpt_path(args.output_dir, "baseline", c, f"conf{c}"), cfg)
        for c, cfg in zip(confs, configs)}


def test_ensemble(args) -> Dict[str, Dict[str, float]]:
    from vit3d_ensemble_tpu_torch.models import TransformerEnsemble
    from vit3d_ensemble_tpu_torch.sweep.ensemble_sweep import compute_member_logits
    from vit3d_ensemble_tpu_torch.train.steps import ensemble_eval_step

    confs = parse_conf_list(args.ensemble_conf_list)
    name = "_".join(str(c) for c in confs)
    configs = [ViTConfig.from_conf(c, img_size=args.img_size) for c in confs]
    k = len(confs)

    res: Dict[str, Dict[str, float]] = {}
    meta_path = _cv_ensemble_ckpt(args, name, "meta_heads")
    if (not os.path.exists(meta_path)
            and not os.path.exists(_cv_ensemble_ckpt(args, name, "cv1"))
            and not getattr(args, "ood", False)):
        # No checkpoints: the e2e grid's resume markers hold held-out test
        # metrics under each fold's accepted best params (the default
        # 816x5 grid keeps metrics, not checkpoints).  Canonical split
        # only: OOD needs the parameters.
        markers = _e2e_marker_test_results(args)
        if markers and name in markers:
            res = {f"CV {cv + 1}": dict(markers[name][f"CV {cv + 1}"])
                   for cv in range(args.cv)}
            logger.info("ensemble %s: metrics from e2e sweep markers "
                        "(no checkpoints on disk)", name)
            _log_aggregate("Ensemble ViT", res)
            return res
    model = members = blob = None
    for cv in range(args.cv):
        test = _fold_test_split(args, cv)
        e2e_path = _cv_ensemble_ckpt(args, name, f"cv{cv + 1}")
        if os.path.exists(e2e_path):
            # end-to-end checkpoint: the whole ensemble's state_dict
            if model is None:
                model = TransformerEnsemble(configs, device=args.device)
                model.eval()
            model.load_state_dict(load_state_dict(e2e_path))
            probs = ensemble_eval_step(
                model, torch.as_tensor(test.volumes, device=args.device)
            ).cpu().numpy()
        elif os.path.exists(meta_path):
            # frozen meta head: the members' logits, then Linear(k, 1)
            if members is None:
                members = _members(args, confs, configs)
                blob = load_state_dict(meta_path)
            logits = compute_member_logits(members, test.volumes,
                                           args.img_size, device=args.device)
            stack = np.stack([logits[c] for c in confs])       # (k, T)
            wb = blob["meta_wb"].numpy()[cv]
            probs = 1.0 / (1.0 + np.exp(-(stack.T @ wb[:k] + wb[k])))
        else:
            raise FileNotFoundError(
                f"no ensemble checkpoint for {name}: looked for {e2e_path} "
                f"and {meta_path}.  The default train_ensemble_cv grid "
                "mode keeps metrics + resume markers only — pass "
                "--save_ensembles there to write per-fold e2e checkpoints, "
                "or use --all_ensembles here to rank from the sweep "
                "markers directly")
        res[f"CV {cv + 1}"] = held_out_metrics(test.labels, probs)
    _log_aggregate("Ensemble ViT", res)
    return res


def _e2e_marker_test_results(args):
    """Held-out test metrics of END-TO-END-trained ensembles, read from the
    grid sweep's resume markers (the grid evaluates the test split under
    each accepted best params during training, so no checkpoints are
    needed).  Returns {combo_name: {fold: metrics}} or None when no marker
    carries test metrics.  Of markers from several sweep settings, the
    largest group is taken, as JAX's driver does (ROADMAP.md §3)."""
    state_dir = os.path.join(args.output_dir, "sweep_state")
    groups: Dict[str, Dict[str, Dict]] = {}
    legacy = 0
    for path in sorted(glob.glob(os.path.join(state_dir, "e2e_*.json"))):
        try:
            with open(path) as f:
                blob = json.load(f)
        except ValueError:
            continue
        if not isinstance(blob, dict):
            continue
        if "combo" not in blob or "test" not in blob or not blob["test"]:
            legacy += 1
            continue
        if len(blob["test"]) != args.cv:
            continue        # sweep ran with a different fold count
        name = "_".join(str(c) for c in blob["combo"])
        groups.setdefault(blob.get("fingerprint", ""), {})[name] = blob["test"]
    if not groups:
        return None
    if legacy:
        logger.warning(
            "%d e2e sweep markers carry no held-out test metrics (legacy "
            "val-only schema) and are excluded — re-run train_ensemble_cv "
            "--resume to backfill them", legacy)
    fp = max(groups, key=lambda k: len(groups[k]))
    if len(groups) > 1:
        logger.warning(
            "e2e markers from %d different sweep settings found; using the "
            "largest group (%s, %d combos)", len(groups), fp,
            len(groups[fp]))
    return groups[fp]


def _write_ranking(args, results, ranking, source: str):
    """Sort the ranking by median test AUROC, best first, and write the
    results' workbook."""
    from vit3d_ensemble_tpu_torch.reporting import write_sweep_report

    ranking.sort(key=lambda t: -t[1])
    report = os.path.join(args.output_path or args.output_dir,
                          "Test_All_Ensembles")
    write_sweep_report(report, results)
    logger.info("full %stest ranking written to %s.xlsx / .csv (%d combos%s)",
                "END-TO-END " if source else "", report, len(results),
                source)
    for name, auc in ranking[:10]:
        logger.info("test median AUROC %.4f  ensemble %s", auc, name)
    return ranking


def test_all_ensembles(args):
    """Rank every trained C(18,3) combination on the held-out test split.

    Two sources, best first:
      * END-TO-END sweep markers (the grid mode of train_ensemble_cv): the
        test metrics of the backbone-fine-tuned ensembles, computed during
        training under each fold's accepted best params.  Skipped under
        --ood (markers hold canonical-split metrics only).
      * frozen meta_heads checkpoints: the 18 members' logits run once per
        fold normalization, then every (combination, fold) head evaluated
        in one batched metrics program on the device (`torch.vmap` over
        `compute_eval_metrics`).

    Returns ({combo_name: {fold: {metric: value}}}, ranking) where ranking
    is [(combo_name, median_AUROC)] best-first.
    """
    from vit3d_ensemble_tpu_torch.sweep.ensemble_sweep import (
        all_combinations,
        compute_member_logits,
    )

    if not getattr(args, "ood", False):
        e2e = _e2e_marker_test_results(args)
        if e2e:
            ranking = [(name, float(np.median([f["AUROC"] for f in folds.values()])))
                       for name, folds in e2e.items()]
            return e2e, _write_ranking(args, e2e, ranking, ", from sweep markers")
        logger.info("no e2e sweep markers with test metrics under %s — "
                    "falling back to frozen meta_heads checkpoints (NOTE: "
                    "frozen rankings do not track end-to-end rankings, "
                    "docs/RESULTS.md)",
                    os.path.join(args.output_dir, "sweep_state"))

    confs = list(range(1, args.max_configs))
    members = _members(args, confs, [ViTConfig.from_conf(c, img_size=args.img_size)
                                     for c in confs])

    # member logits per fold normalization: (F, n_members, T)
    fold_logits = []
    labels = None
    for cv in range(args.cv):
        test = _fold_test_split(args, cv)
        lg = compute_member_logits(members, test.volumes, args.img_size,
                                   device=args.device)
        fold_logits.append(np.stack([lg[c] for c in confs]))
        labels = test.labels
    L = np.stack(fold_logits)                        # (F, M, T)

    combos = all_combinations(args.max_configs, args.combinations)
    conf_row = {c: i for i, c in enumerate(confs)}
    K = combos.shape[1]
    meta = np.zeros((len(combos), args.cv, K + 1), np.float32)
    rows = np.zeros((len(combos), K), np.int64)
    have = np.zeros(len(combos), bool)
    for ci, comb in enumerate(combos):
        name = "_".join(str(c) for c in comb)
        path = _cv_ensemble_ckpt(args, name, "meta_heads")
        if not os.path.exists(path):
            continue
        meta[ci] = load_state_dict(path)["meta_wb"].numpy()
        rows[ci] = [conf_row[int(c)] for c in comb]
        have[ci] = True
    kept = np.flatnonzero(have)
    if not len(kept):
        raise FileNotFoundError(
            "no trained meta_heads checkpoints found under "
            f"{args.output_dir}/cv_ensemble_models and no e2e sweep "
            "markers with test metrics — run train_ensemble_cv first "
            "(default grid mode writes rankable markers; --frozen writes "
            "meta_heads)")
    if len(kept) < len(combos):
        logger.warning("%d/%d combos have no meta_heads checkpoint and are "
                       "skipped", len(combos) - len(kept), len(combos))

    metrics = frozen_head_metrics(meta[kept], rows[kept], L, labels,
                                  args.device)          # (C, F, 11)
    results: Dict[str, Dict[str, Dict[str, float]]] = {}
    ranking = []
    auroc = METRIC_KEYS.index("AUROC")
    for j, ci in enumerate(kept):
        name = "_".join(str(c) for c in combos[ci])
        results[name] = {
            f"CV {f + 1}": dict(zip(METRIC_KEYS, map(float, metrics[j, f])))
            for f in range(args.cv)}
        ranking.append((name, float(np.median(metrics[j, :, auroc]))))
    return results, _write_ranking(args, results, ranking, "")


@torch.no_grad()
def frozen_head_metrics(meta_wb: np.ndarray, rows: np.ndarray,
                        logits: np.ndarray, labels: np.ndarray,
                        device) -> np.ndarray:
    """The 11 metrics (C, F, 11) of every (combination, fold) head on the
    test split, in one batched program on `device`.

    meta_wb (C, F, K + 1) [w1 .. wK b]; rows (C, K), each member's row in
    logits (F, M, T); labels (T,)."""
    meta = torch.as_tensor(meta_wb, device=device)
    L = torch.as_tensor(logits, device=device)
    C, F, K1 = meta.shape
    y = torch.as_tensor(labels, dtype=torch.float32, device=device)
    mask = torch.ones_like(y)
    sel = L[:, torch.as_tensor(rows, device=device)]          # (F, C, K, T)
    z = (torch.einsum("fckt,cfk->cft", sel, meta[..., :K1 - 1])
         + meta[..., K1 - 1:])
    probs = torch.sigmoid(z).reshape(C * F, -1)
    vec = torch.vmap(lambda p: metrics_vector(compute_eval_metrics(p, y, mask)))
    return vec(probs).reshape(C, F, -1).cpu().numpy()


def main(argv=None):
    setup_logging()
    args = build_parser().parse_args(argv)
    apply_runtime_flags(args)
    out_path = args.output_path or args.output_dir
    res_base = test_baseline(args) if args.baseline else None
    res_ens = None
    if args.all_ensembles:
        all_res, ranking = test_all_ensembles(args)
        # the best-ranked combination stands in as "the ensemble" for the
        # cross-model statistics below
        res_ens = all_res[ranking[0][0]]
        if args.baseline:
            logger.warning(
                "statistics below compare the baseline against the combo "
                "selected POST HOC by test-set AUROC over %d candidates — "
                "the p-values carry selection bias; for honest inference "
                "test a pre-registered combination with --ensemble",
                len(ranking))
    elif args.ensemble:
        res_ens = test_ensemble(args)
    stats = None
    if res_base and res_ens:
        stats = compute_statistics(res_base, res_ens, out_path)
        for k, v in stats.items():
            logger.info("%s: %s", k, v)
    return res_base, res_ens, stats


def cli() -> int:
    """Console-script entry: main returns the result dicts for programmatic
    use; setuptools wraps the entry point in sys.exit(), so return 0."""
    main()
    return 0


if __name__ == "__main__":
    main()
