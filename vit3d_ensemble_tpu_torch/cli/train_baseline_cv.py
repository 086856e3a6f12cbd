"""5-fold CV baseline trainer — mirrors `train_baseline_cv.py` (reference),
the port's counterpart of `vit3d_ensemble_tpu/cli/train_baseline_cv.py`.

Usage (the reference's flags, `train_baseline_cv.py:221-263`):

    python -m vit3d_ensemble_tpu_torch.cli.train_baseline_cv --config 5 \
        --csv_path .../csv_files/cross_validation --data_root .../dataset

`--all_configs` runs the 18-config sweep as one grouped multi-model run per
(hidden, heads) shape class instead of 18 x 5 separate runs (`sweep/`).
Runs on the CUDA device unless `--device cpu`.

NOTE: the reference forbids --config 1 via a buggy assert (defect D2,
`train_baseline_cv.py:55-56`); all 18 README configs are allowed here.
"""

from __future__ import annotations

import argparse
import logging
import os

from vit3d_ensemble_tpu_torch.checkpoint import baseline_ckpt_path
from vit3d_ensemble_tpu_torch.cli._common import (
    add_baseline_flags,
    add_common_flags,
    apply_runtime_flags,
    setup_logging,
)
from vit3d_ensemble_tpu_torch.configs import ViTConfig
from vit3d_ensemble_tpu_torch.data import build_train_val
from vit3d_ensemble_tpu_torch.metrics.host import (
    brier_score_one_class,
    calculate_confidence_metrics,
)
from vit3d_ensemble_tpu_torch.sweep.engine import run_cv_sweep
from vit3d_ensemble_tpu_torch.train.trainer import train_baseline
from vit3d_ensemble_tpu_torch.utils.metrics_log import default_logger

logger = logging.getLogger("train_baseline_cv")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    add_common_flags(parser, csv_subdir="cross_validation")
    add_baseline_flags(parser, eval_every=24, num_steps=100)
    parser.add_argument("--num_cv", type=int, default=5,
                        help="How many folds in CV.")
    return parser


def run_single_config(args) -> dict:
    """The reference flow: per fold, fresh model, train, report
    (`train_baseline_cv.py:266-306`)."""
    results = {}
    config = ViTConfig.from_conf(args.config, img_size=args.img_size)
    for cv in range(args.num_cv):
        train_split, val_split, _ = build_train_val(
            os.path.join(args.csv_path, f"training_cv{cv + 1}.csv"),
            os.path.join(args.csv_path, f"validation_cv{cv + 1}.csv"),
            args.data_root, aug_mode=args.aug_mode, size=args.img_size,
            device=args.device,
        )
        logger.info("***** Running Cross Validation %d *****", cv + 1)
        save_path = baseline_ckpt_path(args.output_dir, "cv_baseline",
                                       args.config, f"cv{cv + 1}")
        res = train_baseline(
            config, train_split, val_split,
            num_steps=args.num_steps, eval_every=args.eval_every,
            train_batch_size=args.train_batch_size,
            learning_rate=args.learning_rate,
            weight_decay=args.weight_decay,
            warmup_steps=args.warmup_steps, decay_type=args.decay_type,
            seed=args.seed, save_path=save_path, keep_best_params=False,
            gradient_accumulation_steps=args.gradient_accumulation_steps,
            metrics_logger=default_logger(args.output_dir),
            device=args.device,
        )
        # confidence metrics on the best eval (`train_baseline_cv.py:281-284`)
        csp, cse = calculate_confidence_metrics(
            res.true_labels, res.predicted_labels, res.class_probabilities)
        m = dict(res.metrics)
        m["CSP"], m["CSE"] = csp, cse
        m["BSNC"] = brier_score_one_class(res.true_labels,
                                          res.class_probabilities, cl=0)
        m["BSPC"] = brier_score_one_class(res.true_labels,
                                          res.class_probabilities, cl=1)
        results[f"CV {cv + 1}"] = m

    for cv in range(args.num_cv):
        logger.info("--- CV FOLD # %d ---", cv + 1)
        for metric, value in results[f"CV {cv + 1}"].items():
            logger.info("%s: %s", metric, value)
    return results


def run_all_configs(args) -> dict:
    return run_cv_sweep(args, device=args.device)


def main(argv=None):
    setup_logging()
    args = build_parser().parse_args(argv)
    apply_runtime_flags(args)
    if args.all_configs:
        return run_all_configs(args)
    return run_single_config(args)


def cli() -> int:
    """Console-script entry: main returns the result dict for programmatic
    use; setuptools wraps the entry point in sys.exit(), so return 0."""
    main()
    return 0


if __name__ == "__main__":
    main()
