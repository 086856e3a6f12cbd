"""Fixed-split ensemble retrain — mirrors `train_ensemble_whole_dataset.py`,
the port's counterpart of
`vit3d_ensemble_tpu/cli/train_ensemble_whole_dataset.py`.

    python -m vit3d_ensemble_tpu_torch.cli.train_ensemble_whole_dataset \
        --ensemble_conf_list 5,9,11 --csv_path .../csv_files/fixed_split \
        --data_root .../dataset --output_dir <the baselines' output_dir>

Reference flow (`train_ensemble_whole_dataset.py:31-186`): load the
baseline checkpoints trained on the fixed split
(`baseline_models/conf{c}/conf{c}.bin`), build the stacking ensemble,
Adam(1e-4) + BCELoss end-to-end (backbones NOT frozen) for --num_epochs
over the raw (un-augmented) normalized fixed split, select by the
spec/sens/AUROC rule, then add the confidence metrics and Brier scores.
The best ensemble goes to
`best_ensemble_models/ensemble_{name}/best_ensemble_model.bin`.

`--random_init_members` replaces missing baseline checkpoints with fresh
inits (useful for smoke runs; the reference hard-requires the .bin files).
Runs on the CUDA device unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import logging
import os

from vit3d_ensemble_tpu_torch.checkpoint import (
    baseline_ckpt_path,
    ensemble_ckpt_path,
    load_baseline_params,
)
from vit3d_ensemble_tpu_torch.cli._common import (
    add_common_flags,
    apply_runtime_flags,
    parse_conf_list,
    setup_logging,
)
from vit3d_ensemble_tpu_torch.configs import ViTConfig
from vit3d_ensemble_tpu_torch.data import build_train_val
from vit3d_ensemble_tpu_torch.metrics.host import (
    brier_score_one_class,
    calculate_confidence_metrics,
)
from vit3d_ensemble_tpu_torch.train import trainer
from vit3d_ensemble_tpu_torch.train.ensemble_trainer import train_ensemble

logger = logging.getLogger("train_ensemble_whole_dataset")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    add_common_flags(parser, csv_subdir="fixed_split")
    parser.add_argument("--num_cv", type=int, default=5,
                        help="Accepted for reference CLI parity and "
                             "ignored, matching upstream: the reference "
                             "declares it on this fixed-split driver "
                             "(train_ensemble_whole_dataset.py) but "
                             "never loops folds here.")
    parser.add_argument("--ensemble_conf_list", default="5,9,11",
                        help="Comma-separated baseline configs composing "
                             "the ensemble (README best: 5,9,11).")
    parser.add_argument("--num_epochs", type=int, default=100,
                        help="Training epochs.")
    parser.add_argument("--learning_rate", type=float, default=1e-4,
                        help="Adam learning rate "
                             "(train_ensemble_whole_dataset.py:53).")
    parser.add_argument("--output_path", default=None,
                        help="Alias of --output_dir (reference ensemble "
                             "drivers use this name).")
    parser.add_argument("--random_init_members", action="store_true",
                        help="Use fresh baseline inits when checkpoints "
                             "are absent.")
    return parser


def load_member(args, conf: int):
    """(config, state_dict) of baseline `conf` from
    `baseline_models/conf{c}/conf{c}.bin` under --output_dir, or a fresh
    init under --random_init_members."""
    cfg = ViTConfig.from_conf(conf, img_size=args.img_size)
    path = baseline_ckpt_path(args.output_dir, "baseline", conf, f"conf{conf}")
    if os.path.exists(path):
        return cfg, load_baseline_params(path, cfg)
    if args.random_init_members:
        logger.warning("no checkpoint for conf %d — random init", conf)
        return cfg, trainer.init_baseline(cfg, args.seed, device="cpu").state_dict()
    raise FileNotFoundError(
        f"baseline checkpoint missing: {path} (train it with "
        "train_baseline_whole_dataset, or pass --random_init_members)")


def load_members(args, confs):
    loaded = [load_member(args, c) for c in confs]
    return [cfg for cfg, _ in loaded], [state for _, state in loaded]


def main(argv=None):
    setup_logging()
    args = build_parser().parse_args(argv)
    apply_runtime_flags(args)
    if args.output_path:
        args.output_dir = args.output_path
    confs = parse_conf_list(args.ensemble_conf_list)
    ensemble_name = "_".join(str(c) for c in confs)

    configs, members = load_members(args, confs)
    # no augmentation in ensemble training (train_ensemble_*.py loaders)
    train_split, val_split, _ = build_train_val(
        os.path.join(args.csv_path, "training.csv"),
        os.path.join(args.csv_path, "validation.csv"),
        args.data_root, aug_mode="none", size=args.img_size)

    save_path = ensemble_ckpt_path(args.output_dir, "best_ensemble",
                                   ensemble_name, "best_ensemble_model")
    res = train_ensemble(
        configs, members, train_split, val_split,
        num_epochs=args.num_epochs,
        train_batch_size=args.train_batch_size,
        learning_rate=args.learning_rate, seed=args.seed,
        save_path=save_path, keep_best_params=False, device=args.device)

    csp, cse = calculate_confidence_metrics(
        res.true_labels, res.predicted_labels, res.class_probabilities)
    m = dict(res.metrics)
    m["CSP"], m["CSE"] = csp, cse
    m["BSNC"] = brier_score_one_class(res.true_labels,
                                      res.class_probabilities, 0)
    m["BSPC"] = brier_score_one_class(res.true_labels,
                                      res.class_probabilities, 1)
    logger.info("ensemble %s best metrics:", ensemble_name)
    for k, v in m.items():
        logger.info("  %s: %s", k, v)
    return m


def cli() -> int:
    """Console-script entry: main returns the result dict for programmatic
    use; setuptools wraps the entry point in sys.exit(), so return 0."""
    main()
    return 0


if __name__ == "__main__":
    main()
