"""Shared CLI plumbing for the driver scripts.

The counterpart of `vit3d_ensemble_tpu/cli/_common.py`: the reference's
flag names and defaults (`train_baseline_cv.py:222-263`,
`train_baseline_whole_dataset.py:241-279`), typed.  Where the port differs:

  * `--device` chooses the device, CUDA by default (`cpu` for the tests),
    as the reference's torch drivers do (`train_baseline_cv.py:261-262`);
    the JAX package ignores it;
  * `--attention_impl` takes the port's auto|plain|kernel|layer
    (`ops/attention.py`) and JAX's spellings: xla and vpu -> plain,
    pallas -> kernel;
  * `--mlp_impl` takes auto|plain|kernel (`ops/mlp.py`), plus xla -> plain
    and pallas -> kernel; its default is auto, so evaluation launches the
    fused FFN kernel on the card, where the JAX default is its XLA path;
  * `--quant_impl` sets `ops/quant.py`'s selector, as JAX's does;
  * `--mesh MxN` runs the sweeps over M·N torch.distributed ranks
    (`parallel/mesh.py`): start the driver under torchrun, e.g.
    `torchrun --standalone --nproc_per_node=2 -m
    vit3d_ensemble_tpu_torch.cli.train_baseline_cv --all_configs --mesh
    1x2`; `main(argv)` also runs in a process group that is already
    initialised.  Every rank returns the whole results, and rank 0 alone
    writes;
  * `setup_logging` keeps no compilation cache (there is no XLA).
"""

from __future__ import annotations

import argparse
import logging
import os

from vit3d_ensemble_tpu_torch.ops.attention import set_default_attention_impl
from vit3d_ensemble_tpu_torch.ops.mlp import set_default_mlp_impl
from vit3d_ensemble_tpu_torch.ops.quant import set_default_quant_impl
from vit3d_ensemble_tpu_torch.parallel.mesh import init_distributed, rank_device
from vit3d_ensemble_tpu_torch.utils.debug import enable_nan_checking

#: The JAX package's impl names, as the port's.
ATTENTION_SPELLINGS = {"xla": "plain", "vpu": "plain", "pallas": "kernel"}
MLP_SPELLINGS = {"xla": "plain", "pallas": "kernel"}


def setup_logging() -> None:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )


def add_common_flags(parser: argparse.ArgumentParser,
                     csv_subdir: str = "cross_validation") -> None:
    parser.add_argument("--name", default="prostateX",
                        help="Name of this run. Used for monitoring.")
    parser.add_argument("--dataset", choices=["prostateX"],
                        default="prostateX", help="Which downstream task.")
    parser.add_argument("--num_classes", type=int, default=1,
                        help="Number of output classes.")
    parser.add_argument("--output_dir", type=str,
                        default=os.path.join(os.getcwd(), "output"),
                        help="The output directory for checkpoints.")
    parser.add_argument("--csv_path",
                        default=os.path.join(os.getcwd(), "csv_files",
                                             csv_subdir),
                        help="Path where csv files are stored.")
    parser.add_argument("--data_root",
                        default=os.path.join(os.getcwd(), "dataset"),
                        help="Directory with per-patient image folders "
                             "(the reference hard-codes cwd/dataset, "
                             "create_dataset.py:22).")
    parser.add_argument("--img_size", "--image_size", default=128, type=int,
                        help="Resolution size (the reference's ensemble "
                             "drivers spell this --image_size, "
                             "train_ensemble_cv.py:238 — both accepted).")
    parser.add_argument("--device", default="cuda",
                        help="Device to run on: cuda (the default; raises "
                             "without a card) or cpu.")
    parser.add_argument("--train_batch_size", default=4, type=int,
                        help="Total batch size for training.")
    parser.add_argument("--eval_batch_size", default=1, type=int,
                        help="Total batch size for eval (kept for CLI "
                             "parity; eval runs as one batched forward).")
    parser.add_argument("--seed", type=int, default=42,
                        help="random seed for initialization")
    parser.add_argument("--aug_mode", choices=["disk", "device", "none"],
                        default="disk",
                        help="Augmentation source: precomputed folders "
                             "(reference parity) or transforms on the "
                             "device.")
    parser.add_argument("--attention_impl",
                        choices=["auto", "plain", "kernel", "layer",
                                 *ATTENTION_SPELLINGS],
                        default="auto",
                        help="Attention path (ops/attention.py): 'auto' = "
                             "the fused kernel on the card where dropout is "
                             "off, the einsum otherwise; 'plain' = the "
                             "einsum; 'kernel' = the fused kernel; 'layer' "
                             "= the whole-sublayer kernel.  The JAX "
                             "package's 'xla' and 'vpu' mean 'plain', "
                             "'pallas' means 'kernel'.")
    parser.add_argument("--mlp_impl",
                        choices=["auto", "plain", "kernel", *MLP_SPELLINGS],
                        default="auto",
                        help="FFN path (ops/mlp.py): 'auto' = the fused "
                             "kernel on the card where dropout is off; "
                             "'plain' = fc1 -> GELU -> fc2; 'kernel' = the "
                             "fused wrapper.  'xla' means 'plain', 'pallas' "
                             "'kernel'.")
    parser.add_argument("--quant_impl",
                        choices=["none", "int8", "int8_attn"],
                        default="none",
                        help="Quantized inference (ops/quant.py): 'int8' "
                             "= W8A8 attention projections and MLP, "
                             "'int8_attn' = the attention projections only; "
                             "deterministic forwards only.")
    parser.add_argument("--profile_dir", default=None,
                        help="Write a torch.profiler trace of the sweep to "
                             "this directory.")
    parser.add_argument("--debug_nans", action="store_true",
                        help="Raise on a NaN made in any backward op "
                             "(autograd anomaly detection).")
    parser.add_argument("--mesh", default=None,
                        help="Multi-chip mesh 'MODELxDATA' (e.g. 2x4 on a "
                             "v4-8) or 'auto' (all visible devices). The "
                             "sweep shards (config, fold) work across chips;"
                             " default is single-chip.")
    parser.add_argument("--resume", action="store_true",
                        help="Resume a preempted sweep: skip groups whose "
                             "results are recorded under output_dir/"
                             "sweep_state/, and continue mid-group from the "
                             "last --snapshot_every state snapshot.")
    parser.add_argument("--snapshot_every", type=int, default=0,
                        help="Snapshot full sweep train state (params + "
                             "optimizer + best) every N eval periods for "
                             "preemption recovery; 0 disables.")
    parser.add_argument("--remat",
                        action=argparse.BooleanOptionalAction, default=False,
                        help="Rematerialize encoder blocks in the backward "
                             "pass of the grouped sweep (the dropout masks "
                             "replayed: the same results, one block's "
                             "activations held at a time).")


def apply_runtime_flags(args) -> None:
    """Set the process-wide impls from the flags; raise on a `--device`
    that is absent before any data is read.  Under torchrun, join its
    process group (`parallel/mesh.init_distributed`) and take this rank's
    card (`rank_device`: `cuda` becomes `cuda:(LOCAL_RANK % cards)`)."""
    init_distributed(args.device)
    args.device = str(rank_device(args.device))
    args.attention_impl = ATTENTION_SPELLINGS.get(args.attention_impl,
                                                  args.attention_impl)
    args.mlp_impl = MLP_SPELLINGS.get(args.mlp_impl, args.mlp_impl)
    set_default_attention_impl(args.attention_impl)
    set_default_mlp_impl(args.mlp_impl)
    set_default_quant_impl(getattr(args, "quant_impl", "none"))
    if getattr(args, "debug_nans", False):
        enable_nan_checking()


def add_baseline_flags(parser: argparse.ArgumentParser,
                       eval_every: int, num_steps: int) -> None:
    parser.add_argument("--config", type=int, default=5,
                        help="Which configuration to use.")
    parser.add_argument("--all_configs", action="store_true",
                        help="Train ALL 18 baseline configs as one grouped "
                             "multi-model run (the sweep engine).")
    parser.add_argument("--eval_every", default=eval_every, type=int,
                        help="Run prediction on validation set every so "
                             "many steps.")
    parser.add_argument("--learning_rate", default=1e-4, type=float,
                        help="The initial learning rate for SGD.")
    parser.add_argument("--weight_decay", default=1e-2, type=float,
                        help="Weight decay if we apply some.")
    parser.add_argument("--num_steps", default=num_steps, type=int,
                        help="Total number of training steps to perform.")
    parser.add_argument("--decay_type", choices=["cosine", "linear"],
                        default="cosine",
                        help="How to decay the learning rate.")
    parser.add_argument("--warmup_steps", default=1000, type=int,
                        help="Step of training to perform learning rate "
                             "warmup for. (NOTE: the reference default "
                             "exceeds num_steps — defect D17 — and is "
                             "kept for parity.)")
    parser.add_argument("--gradient_accumulation_steps", type=int, default=1,
                        help="Number of update steps to accumulate before "
                             "an update pass.")


def parse_conf_list(s: str):
    """--ensemble_conf_list '5,9,11' -> (5, 9, 11)
    (`train_ensemble_whole_dataset.py:191-200`)."""
    return tuple(int(tok) for tok in str(s).split(",") if tok.strip())
