"""Bootstrap baseline trainer — mirrors `train_baseline_bootstrap.py`, the
port's counterpart of `vit3d_ensemble_tpu/cli/train_baseline_bootstrap.py`.

Reference flow: for boot in range(num_rep=100): resample training.csv with
seed=boot (`train_baseline_bootstrap.py:163,274` + `tools.py:137-147`),
train with the CV hyperparameters, validate on the fixed validation split,
checkpoint per replicate.

    python -m vit3d_ensemble_tpu_torch.cli.train_baseline_bootstrap \
        --config 9 --num_rep 100 --csv_path .../csv_files/fixed_split \
        --data_root .../dataset

The replicate axis is the sweep's fold axis: the grouped engine trains
`--boot_chunk` replicates of every config of a shape class at once from one
shared volume pool (`data/pool.py`); `--all_configs` adds the 18-config
axis on top.  Each (config, replicate) cell keeps the dropout stream of its
global replicate id, so the metrics do not depend on `--boot_chunk`.
Writes `boot_baseline_models/conf{c}/boot{r}.bin` and the
`Baseline_Bootstrap` report.  Runs on the CUDA device unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Dict

from vit3d_ensemble_tpu_torch.cli._common import (
    add_baseline_flags,
    add_common_flags,
    apply_runtime_flags,
    setup_logging,
)
from vit3d_ensemble_tpu_torch.data.pool import build_pooled_bootstrap
from vit3d_ensemble_tpu_torch.reporting import write_sweep_report
from vit3d_ensemble_tpu_torch.sweep.engine import (
    run_grouped_baselines,
    stack_folds,
    sweep_aug_mode,
    sweep_hyper_from_args,
)

logger = logging.getLogger("train_baseline_bootstrap")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    add_common_flags(parser, csv_subdir="fixed_split")
    add_baseline_flags(parser, eval_every=24, num_steps=100)
    parser.add_argument("--num_rep", type=int, default=100,
                        help="Number of bootstrap replicates.")
    parser.add_argument("--boot_chunk", type=int, default=25,
                        help="Replicates per grouped run (0: all of them). "
                             "Each chunk holds its cells' parameters, "
                             "momentum and best state on the device; the "
                             "results do not depend on the chunk.")
    return parser


def main(argv=None) -> Dict:
    setup_logging()
    args = build_parser().parse_args(argv)
    apply_runtime_flags(args)

    hyper = sweep_hyper_from_args(args)
    confs = list(range(1, 19)) if args.all_configs else [args.config]
    chunk = args.boot_chunk if args.boot_chunk > 0 else args.num_rep

    results: Dict[str, Dict] = {}
    for s in range(0, args.num_rep, chunk):
        w = min(chunk, args.num_rep - s)
        # replicate k resamples with seed k globally (seed0=s keeps the
        # chunked run seed-identical to one unchunked num_rep pass)
        pool, reps = build_pooled_bootstrap(
            os.path.join(args.csv_path, "training.csv"),
            os.path.join(args.csv_path, "validation.csv"),
            args.data_root, w, size=args.img_size,
            aug_mode=sweep_aug_mode(args), seed0=s, device=args.device)
        data = stack_folds(pool, reps, hyper)
        logger.info("pool: %d unique volumes for replicates %d..%d",
                    len(pool), s, s + w - 1)
        raw = run_grouped_baselines(
            args, data, hyper, ckpt_kind="boot_baseline",
            fold_label=lambda r, s=s: f"boot{s + r}",
            fold_tag=lambda conf, r, s=s: f"boot{s + r}",
            marker_prefix=f"boot_s{s}", confs=confs,
            # global replicate ids: each cell's dropout stream is keyed on
            # the full (config, num_rep) grid, so the metrics do not depend
            # on --boot_chunk
            fold_ids=range(s, s + w), n_folds_total=args.num_rep,
            device=args.device)
        for c, per_rep in raw.items():
            results.setdefault(f"conf{c}", {}).update(per_rep)

    report = os.path.join(args.output_dir, "Baseline_Bootstrap")
    write_sweep_report(report, results)
    logger.info("report written to %s.xlsx / .csv", report)
    return results


def cli() -> int:
    """Console-script entry: main returns the result dict for programmatic
    use; setuptools wraps the entry point in sys.exit(), so return 0."""
    main()
    return 0


if __name__ == "__main__":
    main()
