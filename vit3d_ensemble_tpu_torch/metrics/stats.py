"""Cross-model statistics: aggregation, hypothesis tests and plots.

The counterpart of `vit3d_ensemble_tpu/metrics/stats.py` (the reference's
`test_cv.py:82-103,193-243`): per-metric median, mean and percentile CIs
over folds, Shapiro-Wilk normality, Mood's median test, Mann-Whitney U,
and the histogram and box plots, saved to files.  scipy is imported inside
`compute_statistics` and matplotlib inside its plotting, as JAX does; the
box plot is drawn by `ax.boxplot` over the six columns, without pandas.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Mapping

import numpy as np


def aggregate_folds(per_fold: Mapping[str, Mapping[str, float]]) -> Dict[str, Dict[str, float]]:
    """per_fold: {'CV 1': {metric: value, ...}, ...} ->
    {metric: {median, mean, p2.5, p97.5, p25, p75}} (`test_cv.py:82-103`)."""
    out: Dict[str, Dict[str, float]] = {}
    folds = list(per_fold.keys())
    if not folds:
        return out
    for metric in per_fold[folds[0]]:
        values = [per_fold[f][metric] for f in folds]
        out[metric] = {
            "median": float(np.median(values)),
            "mean": float(np.mean(values)),
            "p2.5": float(np.percentile(values, 2.5)),
            "p97.5": float(np.percentile(values, 97.5)),
            "p25": float(np.percentile(values, 25)),
            "p75": float(np.percentile(values, 75)),
        }
    return out


def compute_statistics(res_base: Mapping[str, Mapping[str, float]],
                       res_ens: Mapping[str, Mapping[str, float]],
                       output_path: str = ".",
                       make_plots: bool = True) -> Dict[str, object]:
    """Shapiro / median / Mann-Whitney tests and plots (`test_cv.py:193-243`).

    The Brier score is read under 'BS' (the trainers' dicts) or
    'Brier score'.  The plots (`bs_hist.png`, `box_plot.eps`,
    `box_plot.png` under `output_path`) are best-effort: where they cannot
    be drawn, a warning is logged and the statistics are returned all the
    same, as the JAX package does.
    """
    from scipy import stats

    def shapiro_or_note(values):
        """scipy's shapiro needs n >= 3 and returns NaN below (with a
        warning); annotate instead of letting NaN flow into reports."""
        if len(values) < 3:
            return ("n<3: Shapiro-Wilk undefined for "
                    f"{len(values)} folds (need >=3)")
        return stats.shapiro(values)

    def col(res, key_options):
        rows = list(res.values())
        for key in key_options:
            if key in rows[0]:
                return [r[key] for r in rows]
        raise KeyError(key_options)

    auprc_b = col(res_base, ("AUPRC",))
    auprc_e = col(res_ens, ("AUPRC",))
    cse_b = col(res_base, ("CSE",))
    cse_e = col(res_ens, ("CSE",))
    bs_b = col(res_base, ("BS", "Brier score"))
    bs_e = col(res_ens, ("BS", "Brier score"))

    results: Dict[str, object] = {
        "shapiro base": shapiro_or_note(bs_b),
        "shapiro ens": shapiro_or_note(bs_e),
        "median": stats.median_test(bs_b, bs_e),
        "mann_whitney": stats.mannwhitneyu(auprc_b, auprc_e),
    }

    if make_plots:
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            os.makedirs(output_path, exist_ok=True)
            fig, ax = plt.subplots()
            ax.hist(bs_b, alpha=0.6, label="Base", color="orange")
            ax.hist(bs_e, alpha=0.6, label="Ensemble", color="navy")
            ax.legend()
            fig.savefig(os.path.join(output_path, "bs_hist.png"))
            plt.close(fig)

            columns = {
                "AUPRC Base": auprc_b, "AUPRC Ensemble": auprc_e,
                "CSE Base": cse_b, "CSE Ensemble": cse_e,
                "BS Base": bs_b, "BS Ensemble": bs_e,
            }
            fig, ax = plt.subplots(figsize=(10, 5))
            ax.boxplot(list(columns.values()))
            ax.set_xticks(range(1, len(columns) + 1), list(columns))
            ax.grid(True)
            fig.savefig(os.path.join(output_path, "box_plot.eps"),
                        format="eps")
            fig.savefig(os.path.join(output_path, "box_plot.png"))
            plt.close(fig)
        except Exception:  # plotting is best-effort; stats are the contract
            logging.getLogger(__name__).warning(
                "statistics plots could not be written to %s", output_path,
                exc_info=True)
    return results
