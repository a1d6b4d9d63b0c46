"""Artifact writers byte-compatible with the reference PerfSave/PredSave CSVs.

Copy of the writers of `multimodal_transformer_tpu/engine/csv_io.py` that
the CLI uses.  PredSave schema (reference SFT/train.py:600-615): header
`time,pred,actual`, integer time steps from 0.  PerfSave schema (reference
Performance-Eval/train.py:529-572): header `Model,Combination,VidID,Set,CCC`,
appended per evaluation sweep, header written only if the file is new.
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
