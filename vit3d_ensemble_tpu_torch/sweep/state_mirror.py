"""Durable mirroring of sweep resume-marker state.

The counterpart of `vit3d_ensemble_tpu/sweep/state_mirror.py`, a copy of its
four functions (stdlib only), so that either package restores the other's
mirror to the same marker files.

The e2e ensemble grid persists one small JSON resume marker per completed
combination (`cli/train_ensemble_cv.py` and `cli/train_ensemble_bootstrap.py`
grid mode).  Markers live under the run's `--output_dir`, which a container
reset can destroy mid-sweep; this module consolidates the marker directory
into a single JSONL file (kept wherever storage survives, e.g. inside the
repository) and can rehydrate the marker directory from it, making
`--resume` reset-proof.

Formats:
  * mirror JSONL — one line per marker: {"file": <basename>, "marker":
    <marker blob>}.  Later lines win (append-mode writers just add lines).
  * marker files — whatever the sweep wrote; this module treats them as
    opaque JSON.
"""

from __future__ import annotations

import glob
import json
import logging
import os
from typing import Dict, Optional

logger = logging.getLogger(__name__)


def _load_marker(path: str) -> Optional[dict]:
    try:
        with open(path) as f:
            return json.load(f)
    except (ValueError, OSError):
        return None     # markers are written atomically; skip junk


def read_mirror(mirror_path: str) -> Dict[str, dict]:
    """Parse a mirror JSONL into {marker_basename: marker}; last line
    wins, truncated/corrupt lines are skipped (an append interrupted by a
    reset legitimately leaves one)."""
    out: Dict[str, dict] = {}
    if not os.path.exists(mirror_path):
        return out
    with open(mirror_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                row = json.loads(line)
            except ValueError:
                continue
            if isinstance(row, dict) and "file" in row and "marker" in row:
                out[row["file"]] = row["marker"]
    return out


def snapshot(state_dir: str, mirror_path: str) -> int:
    """Consolidate every marker in `state_dir` into `mirror_path`
    (atomic full rewrite; also folds in mirror-only entries so a snapshot
    never loses markers the directory has already lost).  Returns the
    number of markers mirrored.  Covers every driver's markers (e2e_*,
    boot_*): anything `*.json` in the state dir (in-flight writes end
    `.json.tmp` and are excluded)."""
    merged = read_mirror(mirror_path)
    for path in sorted(glob.glob(os.path.join(state_dir, "*.json"))):
        blob = _load_marker(path)
        if blob is not None:
            merged[os.path.basename(path)] = blob
    if not merged:
        return 0
    os.makedirs(os.path.dirname(mirror_path) or ".", exist_ok=True)
    tmp = mirror_path + ".tmp"
    with open(tmp, "w") as f:
        for fname in sorted(merged):
            f.write(json.dumps({"file": fname, "marker": merged[fname]})
                    + "\n")
    os.replace(tmp, mirror_path)
    return len(merged)


def append(mirror_path: str, marker_file: str, marker: dict) -> None:
    """Append one marker to the mirror (O(1); restore dedups last-wins)."""
    os.makedirs(os.path.dirname(mirror_path) or ".", exist_ok=True)
    with open(mirror_path, "a") as f:
        f.write(json.dumps({"file": marker_file, "marker": marker}) + "\n")


def restore(mirror_path: str, state_dir: str) -> int:
    """Write every mirrored marker missing from `state_dir` (existing
    files win — they are at least as fresh).  Returns markers written."""
    mirrored = read_mirror(mirror_path)
    if not mirrored:
        return 0
    os.makedirs(state_dir, exist_ok=True)
    written = 0
    for fname, marker in mirrored.items():
        dest = os.path.join(state_dir, fname)
        if os.path.exists(dest):
            continue
        tmp = dest + ".tmp"
        with open(tmp, "w") as f:
            json.dump(marker, f)
        os.replace(tmp, dest)
        written += 1
    if written:
        logger.info("restored %d sweep marker(s) from mirror %s",
                    written, mirror_path)
    return written
