"""Artifact writers byte-compatible with the reference PerfSave/PredSave CSVs.

Copy of the writers of `multimodal_transformer_tpu/engine/csv_io.py`, the
same bytes.  PredSave schema (reference SFT/train.py:600-615): header
`time,pred,actual`, integer time steps from 0.  PerfSave schema (reference
Performance-Eval/train.py:529-572): header `Model,Combination,VidID,Set,CCC`,
appended per evaluation sweep, header written only if the file is new.
`save_predictions` writes the reference's per-video rating CSVs and
`save_params` appends to its hyperparameter history, param_hist.tsv.
"""

from __future__ import annotations

import csv
import os
from typing import Iterable, List, Sequence


def write_pred_save(path: str, pred: Sequence[float],
                    actual: Sequence[float]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, mode="w", newline="") as f:
        w = csv.writer(f, delimiter=",")
        w.writerow(["time", "pred", "actual"])
        for t, (p, a) in enumerate(zip(pred, actual)):
            w.writerow([t, p, a])


def append_perf_save(path: str, model: str, combination: str,
                     seq_ids: Sequence[str], cccs: Sequence[float],
                     eval_set: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    first_time = not os.path.exists(path)
    with open(path, mode="a", newline="") as f:
        w = csv.writer(f, delimiter=",")
        if first_time:
            w.writerow(["Model", "Combination", "VidID", "Set", "CCC"])
        for sid, c in zip(seq_ids, cccs):
            w.writerow([model, combination, sid, eval_set, c])


def seq_id_strings(seq_ids: Iterable) -> List[str]:
    """('123', '4') -> '123_4' (reference getSeqList, MFT/train.py:516-520)."""
    return [f"{a}_{b}" for a, b in seq_ids]


def save_predictions(seq_ids, predictions, out_dir: str) -> None:
    """Per-video rating CSVs: target_{subj}_{vid}_normal.csv with a 'rating'
    column (reference save_predictions, MFT/train.py:317-321)."""
    os.makedirs(out_dir, exist_ok=True)
    for p, sid in zip(predictions, seq_ids):
        fname = "target_{}_{}_normal.csv".format(*sid)
        with open(os.path.join(out_dir, fname), "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["rating"])
            for v in p:
                w.writerow([v])


def save_params(path: str, *, model_name: str, args_dict: dict,
                train_stats: dict, test_stats: dict,
                extra: dict | None = None) -> None:
    """Append a hyperparameter-history row to param_hist.tsv
    (reference save_params, MFT/train.py:323-343)."""
    cols = {}
    for k in ("ccc", "ccc_std"):
        cols[f"test_{k}"] = test_stats.get(k, float("nan"))
    for k in ("ccc", "ccc_std"):
        cols[f"train_{k}"] = train_stats.get(k, float("nan"))
    cols["model"] = model_name
    for k in ("modalities", "batch_size", "split", "epochs", "lr",
              "sup_ratio", "base_rate"):
        cols[k] = args_dict.get(k)
    if extra:
        cols.update(extra)
    header_needed = not os.path.exists(path)
    if not header_needed:
        # appended rows must line up with the existing header — a changed
        # `extra` key set across runs would otherwise silently misalign
        # columns in the TSV
        with open(path, newline="") as f:
            existing = next(csv.reader(f, delimiter="\t"), None)
        if existing is not None and existing != list(cols.keys()):
            raise ValueError(
                f"save_params: column set {list(cols.keys())} does not "
                f"match the existing header of {path}: {existing}; write "
                f"to a new file or pass matching `extra` keys")
    with open(path, "a", newline="") as f:
        w = csv.writer(f, delimiter="\t")
        if header_needed:
            w.writerow(list(cols.keys()))
        w.writerow([cols[k] for k in cols])
