"""Sweep reports: Excel workbook + CSV, mirroring the reference's xlsxwriter
output (`train_ensemble_cv.py:36-49,221-230`): one row per ensemble, one
column per metric, cells formatted 'mean (std)' over folds/replicates.

The counterpart of `vit3d_ensemble_tpu/reporting.py`, byte for byte in its
CSV and member for member in its workbook.  `write_xlsx` writes the minimal
OOXML subset (a .xlsx is a zip of XML parts) with inline strings, from the
csv and zipfile modules alone: readable by Excel, LibreOffice and pandas.
"""

from __future__ import annotations

import csv
import os
import zipfile
from typing import List, Mapping, Sequence
from xml.sax.saxutils import escape

import numpy as np

from vit3d_ensemble_tpu_torch.parallel.mesh import is_writer

#: Reference workbook metric column order (`train_ensemble_cv.py:45`).
REPORT_METRICS = ("Specificity", "Sensitivity", "Balanced Accuracy", "AUROC",
                  "AUPRC", "F2-score", "CSP", "CSE", "BSNC", "BSPC", "BS")


def _col_name(idx: int) -> str:
    name = ""
    idx += 1
    while idx:
        idx, rem = divmod(idx - 1, 26)
        name = chr(65 + rem) + name
    return name


def write_xlsx(path: str, rows: Sequence[Sequence[object]],
               sheet_name: str = "Sheet1") -> None:
    """Write a single-sheet workbook; rows of str/float cells."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def cell_xml(r, c, value):
        ref = f"{_col_name(c)}{r + 1}"
        if isinstance(value, (int, float, np.floating, np.integer)):
            return f'<c r="{ref}"><v>{value}</v></c>'
        text = escape(str(value))
        return (f'<c r="{ref}" t="inlineStr"><is><t xml:space="preserve">'
                f"{text}</t></is></c>")

    body = "".join(
        f'<row r="{r + 1}">' + "".join(
            cell_xml(r, c, v) for c, v in enumerate(row) if v is not None)
        + "</row>"
        for r, row in enumerate(rows))
    sheet = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<worksheet xmlns="http://schemas.openxmlformats.org/'
        'spreadsheetml/2006/main"><sheetData>' + body
        + "</sheetData></worksheet>")
    workbook = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<workbook xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main" '
        'xmlns:r="http://schemas.openxmlformats.org/officeDocument/2006/relationships">'
        f'<sheets><sheet name="{escape(sheet_name)}" sheetId="1" r:id="rId1"/></sheets>'
        "</workbook>")
    wb_rels = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">'
        '<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/'
        'officeDocument/2006/relationships/worksheet" Target="worksheets/sheet1.xml"/>'
        "</Relationships>")
    root_rels = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">'
        '<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/'
        'officeDocument/2006/relationships/officeDocument" Target="xl/workbook.xml"/>'
        "</Relationships>")
    content_types = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<Types xmlns="http://schemas.openxmlformats.org/package/2006/content-types">'
        '<Default Extension="rels" ContentType="application/vnd.openxmlformats-'
        'package.relationships+xml"/>'
        '<Default Extension="xml" ContentType="application/xml"/>'
        '<Override PartName="/xl/workbook.xml" ContentType="application/vnd.'
        'openxmlformats-officedocument.spreadsheetml.sheet.main+xml"/>'
        '<Override PartName="/xl/worksheets/sheet1.xml" ContentType="application/'
        'vnd.openxmlformats-officedocument.spreadsheetml.worksheet+xml"/>'
        "</Types>")
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("[Content_Types].xml", content_types)
        z.writestr("_rels/.rels", root_rels)
        z.writestr("xl/workbook.xml", workbook)
        z.writestr("xl/_rels/workbook.xml.rels", wb_rels)
        z.writestr("xl/worksheets/sheet1.xml", sheet)


def mean_std_cell(values: Sequence[float]) -> str:
    """'mean (std)' cell format (`train_ensemble_cv.py:224`)."""
    return f"{round(float(np.mean(values)), 3)} ({round(float(np.std(values)), 3)})"


def ensemble_sweep_rows(
    results: Mapping[str, Mapping[str, Mapping[str, float]]],
) -> List[List[object]]:
    """results: {ensemble_name: {fold: {metric: value}}} -> workbook rows
    in the reference layout (header row, then one row per ensemble)."""
    rows: List[List[object]] = [[None], ["Ensemble", *REPORT_METRICS]]
    for name, per_fold in results.items():
        row: List[object] = [name]
        for metric in REPORT_METRICS:
            # trainer dicts use 'Accuracy' where the workbook says
            # 'Balanced Accuracy' (they are the same quantity).
            key = metric if metric != "Balanced Accuracy" else "Accuracy"
            vals = [fold_metrics.get(metric, fold_metrics.get(key))
                    for fold_metrics in per_fold.values()]
            row.append(mean_std_cell(vals))
        rows.append(row)
    return rows


def write_sweep_report(path_base: str,
                       results: Mapping[str, Mapping[str, Mapping[str, float]]]
                       ) -> None:
    """Write <base>.xlsx + <base>.csv for an ensemble/baseline sweep (in a
    process group, rank 0 alone)."""
    if not is_writer():
        return
    rows = ensemble_sweep_rows(results)
    write_xlsx(path_base + ".xlsx", rows)
    with open(path_base + ".csv", "w", newline="") as f:
        w = csv.writer(f)
        for row in rows[1:]:
            w.writerow(["" if c is None else c for c in row])
