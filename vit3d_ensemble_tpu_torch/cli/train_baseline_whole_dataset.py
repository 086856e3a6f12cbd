"""Fixed-split baseline trainer — mirrors `train_baseline_whole_dataset.py`,
the port's counterpart of
`vit3d_ensemble_tpu/cli/train_baseline_whole_dataset.py`.

Reference specifics preserved: fixed_split CSVs, num_steps=1000,
eval_every=31, UNWEIGHTED BCE loss (`train_baseline_whole_dataset.py:186`),
checkpoints to `output/baseline_models/conf{c}/conf{c}.bin`, the files the
ensemble drivers consume (`train_ensemble_cv.py:60,80-81`).  Runs on the
CUDA device unless `--device cpu`.

(The reference script itself does not run: its loader returns None under
the inverted rank guard (defect D3) and it references undefined args
(defect D7); this driver implements the intended behavior.)
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
from vit3d_ensemble_tpu_torch.data.pool import build_pooled_fixed
from vit3d_ensemble_tpu_torch.sweep.engine import (
    run_grouped_baselines,
    stack_folds,
    sweep_aug_mode,
    sweep_hyper_from_args,
)
from vit3d_ensemble_tpu_torch.train.trainer import train_baseline
from vit3d_ensemble_tpu_torch.utils.metrics_log import default_logger

logger = logging.getLogger("train_baseline_whole_dataset")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    add_common_flags(parser, csv_subdir="fixed_split")
    add_baseline_flags(parser, eval_every=31, num_steps=1000)
    parser.add_argument("--max_grad_norm", type=float, default=1.0,
                        help="Accepted for reference CLI parity and "
                             "ignored, matching upstream: the reference "
                             "declares it (train_baseline_whole_dataset"
                             ".py:274) but never clips gradients.")
    return parser


def run_all_configs(args):
    """All 18 baselines on the fixed split as one grouped run per shape
    class: a 1-fold sweep with unweighted loss
    (`train_baseline_whole_dataset.py:186`)."""
    hyper = sweep_hyper_from_args(args, balanced_weights=False)
    pool, folds = build_pooled_fixed(
        os.path.join(args.csv_path, "training.csv"),
        os.path.join(args.csv_path, "validation.csv"),
        args.data_root, size=args.img_size, aug_mode=sweep_aug_mode(args),
        device=args.device)
    data = stack_folds(pool, folds, hyper)
    results = run_grouped_baselines(
        args, data, hyper, ckpt_kind="baseline",
        fold_label=lambda f: "fixed",
        fold_tag=lambda conf, f: f"conf{conf}",
        marker_prefix="whole", device=args.device)
    return {conf: per_fold["fixed"] for conf, per_fold in results.items()}


def main(argv=None):
    setup_logging()
    args = build_parser().parse_args(argv)
    apply_runtime_flags(args)

    if args.all_configs:
        return run_all_configs(args)

    configs = [args.config]
    train_split, val_split, _ = build_train_val(
        os.path.join(args.csv_path, "training.csv"),
        os.path.join(args.csv_path, "validation.csv"),
        args.data_root, aug_mode=args.aug_mode, size=args.img_size,
        device=args.device,
    )
    all_results = {}
    for conf in configs:
        config = ViTConfig.from_conf(conf, img_size=args.img_size)
        save_path = baseline_ckpt_path(args.output_dir, "baseline", conf,
                                       f"conf{conf}")
        res = train_baseline(
            config, train_split, val_split,
            num_steps=args.num_steps, eval_every=args.eval_every,
            train_batch_size=args.train_batch_size,
            learning_rate=args.learning_rate,
            weight_decay=args.weight_decay,
            warmup_steps=args.warmup_steps, decay_type=args.decay_type,
            seed=args.seed, save_path=save_path, keep_best_params=False,
            balanced_weights=False,
            gradient_accumulation_steps=args.gradient_accumulation_steps,
            metrics_logger=default_logger(args.output_dir),
            device=args.device,
        )
        logger.info("conf %d (%.3fM params) best metrics:", conf,
                    res.num_params_m)
        for k, v in res.metrics.items():
            logger.info("  %s: %s", k, v)
        all_results[conf] = res.metrics
    return all_results


def cli() -> int:
    """Console-script entry: main returns the result dict for programmatic
    use; setuptools wraps the entry point in sys.exit(), so return 0."""
    main()
    return 0


if __name__ == "__main__":
    main()
