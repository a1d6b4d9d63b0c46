"""SENDv1 host-side reader, without pandas (numpy and the `csv` module).

Counterpart of `multimodal_transformer_tpu/data/send.py`, whose reference
semantics is its pandas path (`load_send(..., use_native=False)`, after
reference MFT/datasets.py:11-191 and :241-297): files found per modality by
regex with (subject, video) sequence IDs, strict cross-modality ID
alignment, tsv/csv/ssv/txt tables sliced by column label, and `ratings` plus
a timer per modality always added.  The port gives the same arrays:

  * headers are kept as written, so the acoustic labels keep their leading
    space (" frameTime");
  * csv and txt split on commas, tsv on tabs (both with the `csv` module's
    quoting, as pandas' C parser), ssv on runs of whitespace;
  * an empty field, or one of pandas' default NA strings, is NaN; a short
    row is padded with NaN, as pandas does; a row longer than the header
    raises;
  * every field is parsed by Python's `float` (correctly rounded), the
    features then rounded once to float32 and the timers kept in float64;
  * label slices are inclusive, and a missing `col_stop` means the last
    column;
  * the sequence length of a video comes from its tsv modality.

`load_send(..., use_native=True)`, the default as in the JAX package, reads
each table with the native parser (native/fastload.cpp through
data/native_loader.py, built with g++ at first use) and slices its header
as the JAX native path does; the parser reads float32, so its timers are
float32 values widened to float64.  A table it refuses (a row wider than
its header), or any table when the library cannot be built, is read by the
Python path above.  One line on the "mmtx.data" logger (the CLI's log)
says which parser read each split's files.
"""

from __future__ import annotations

import csv
import logging
import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np

from . import native_loader

log = logging.getLogger("mmtx.data")


@dataclass(frozen=True)
class ChannelSpec:
    subdir: str                    # relative to base_dir
    regex: str                     # filename pattern with (subject, video) groups
    fmt: str                       # tsv | csv | ssv | txt
    col_start: str                 # first feature column label (inclusive)
    col_stop: str                  # last feature column label (inclusive)
    scale: float = 1.0             # applied after slicing (ratings / 100)
    timer_col: str = ""            # timestamp column label


# Directory layout, filename regexes, and column slices exactly as wired in the
# reference loader (MFT/datasets.py:244-280).
SCHEMA: Dict[str, ChannelSpec] = {
    "linguistic": ChannelSpec(
        subdir=os.path.join("features", "{subset}", "linguistic-word-level"),
        regex=r"ID(\d+)_vid(\d+)_.*\.tsv", fmt="tsv",
        col_start="glove0", col_stop="glove299", timer_col="time-offset"),
    "linguistic_bert": ChannelSpec(
        subdir=os.path.join("features", "{subset}",
                            "linguistic-word-level-bert"),
        regex=r"ID(\d+)_vid(\d+)_.*\.tsv", fmt="tsv",
        col_start="bert0", col_stop="bert1023", timer_col="time-offset"),
    "emotient": ChannelSpec(
        subdir=os.path.join("features", "{subset}", "emotient"),
        regex=r"ID(\d+)_vid(\d+)_.*\.txt", fmt="txt",
        col_start="AU1", col_stop="AU43", timer_col="Frametime"),
    "image": ChannelSpec(
        subdir=os.path.join("features", "{subset}", "image"),
        regex=r"ID(\d+)_vid(\d+)_.*\.ssv", fmt="ssv",
        col_start="vector0", col_stop="vector999", timer_col="Frametime"),
    "acoustic": ChannelSpec(
        subdir=os.path.join("features", "{subset}", "acoustic-egemaps"),
        regex=r"ID(\d+)_vid(\d+)_.*\.csv", fmt="csv",
        col_start=" F0semitoneFrom27.5Hz_sma3nz_amean",
        col_stop=" equivalentSoundLevel_dBp", timer_col=" frameTime"),
    "ratings": ChannelSpec(
        subdir=os.path.join("ratings", "{subset}", "observer_EWE"),
        regex=r"results_(\d+)_(\d+)\.csv", fmt="csv",
        col_start="evaluatorWeightedEstimate",
        col_stop="evaluatorWeightedEstimate", scale=1.0 / 100.0,
        timer_col="time"),
}

# pandas' default na_values (pandas/_libs/parsers.pyx STR_NA_VALUES)
NA_STRINGS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"})


@dataclass
class SendDataset:
    """Per-video aligned multimodal sequences (host memory, numpy)."""
    modalities: Tuple[str, ...]
    seq_ids: List[Tuple[str, str]]
    data: Dict[str, List[np.ndarray]]      # mod -> per-video [T_i, D] float32
    timers: Dict[str, List[np.ndarray]]    # mod -> per-video [T_i] float64
    lengths: List[int] = field(default_factory=list)

    def __len__(self):
        return len(self.seq_ids)

    def normalize(self) -> "SendDataset":
        """Rescale every modality to [-1, 1] using per-dimension global
        min/max (reference datasets.py:140-154 normalize_)."""
        data = {}
        for m in self.modalities:
            m_max = np.stack([a.max(0) for a in self.data[m]]).max(0)
            m_min = np.stack([a.min(0) for a in self.data[m]]).min(0)
            rng = m_max - m_min
            rng = np.where(rng > 0, rng, 1e-10)
            data[m] = [(a - m_min) / rng * 2 - 1 for a in self.data[m]]
        return SendDataset(self.modalities, list(self.seq_ids), data,
                           {m: list(v) for m, v in self.timers.items()},
                           list(self.lengths))

    def split(self, n: int) -> "SendDataset":
        """Split each sequence into n chunks (reference datasets.py:162-175)."""
        data = {m: [c for a in self.data[m] for c in np.array_split(a, n, 0)]
                for m in self.modalities}
        timers = {m: [c for a in self.timers[m]
                      for c in np.array_split(a, n, 0)]
                  for m in self.timers}
        seq_ids = [i for i in self.seq_ids for _ in range(n)]
        lengths = [len(d) for d in data[self.modalities[0]]]
        return SendDataset(self.modalities, seq_ids, data, timers, lengths)

    @classmethod
    def merge(cls, a: "SendDataset", b: "SendDataset") -> "SendDataset":
        if a.modalities != b.modalities:
            raise ValueError("Modalities need to match.")
        return cls(a.modalities, a.seq_ids + b.seq_ids,
                   {m: a.data[m] + b.data[m] for m in a.modalities},
                   {m: a.timers[m] + b.timers[m] for m in a.timers},
                   a.lengths + b.lengths)


def read_table(path: str, fmt: str) -> Tuple[List[str], np.ndarray]:
    """Returns (column labels, [rows, columns] float64).  Blank lines are
    skipped, as pandas skips them."""
    with open(path, newline="") as f:
        if fmt == "ssv":
            rows = [line.split() for line in f]
        else:
            rows = list(csv.reader(f, delimiter="\t" if fmt == "tsv" else ","))
    rows = [r for r in rows if r]
    if not rows:
        raise ValueError(f"{path}: no header")
    header, body = rows[0], rows[1:]
    n = len(header)
    for i, r in enumerate(body):
        if len(r) > n:
            raise ValueError(f"{path}: line {i + 2} has {len(r)} fields, "
                             f"the header {n}")
        if len(r) < n:
            body[i] = r + [""] * (n - len(r))
    values = np.fromiter(
        (float("nan") if v.strip() in NA_STRINGS else float(v)
         for r in body for v in r), dtype=np.float64, count=len(body) * n)
    return header, values.reshape(len(body), n)


def _load_native(path: str, spec: ChannelSpec):
    """The JAX package's native path: (features [T, D] float32, timer [T]
    float64) from the native parser and its header, or None where the
    parser refuses the file or lacks the first feature column."""
    parsed = native_loader.parse_table(path, spec.fmt)
    if parsed is None:
        return None
    arr, header = parsed
    idx = {h: i for i, h in enumerate(header)}
    if spec.col_start not in idx:
        return None
    start = idx[spec.col_start]
    stop = idx.get(spec.col_stop, len(header) - 1)
    feats = arr[:, start:stop + 1].astype(np.float32) * spec.scale
    return feats, arr[:, idx[spec.timer_col]].astype(np.float64)


def _load_columns(path: str, spec: ChannelSpec):
    """Returns (features [T, D] float32, timer [T] float64)."""
    header, table = read_table(path, spec.fmt)
    idx: Dict[str, int] = {}
    for i, h in enumerate(header):
        idx.setdefault(h, i)
    if spec.col_start not in idx or spec.timer_col not in idx:
        missing = [c for c in (spec.col_start, spec.timer_col)
                   if c not in idx]
        raise KeyError(f"{path}: no column {missing[0]!r}")
    start = idx[spec.col_start]
    stop = idx.get(spec.col_stop, len(header) - 1)
    feats = table[:, start:stop + 1].astype(np.float32) * spec.scale
    return feats, table[:, idx[spec.timer_col]].copy()


def _discover(dir_path: str, regex: str) -> List[Tuple[Tuple[str, str], str]]:
    """Returns sorted [(seq_id, path)] for files matching the regex."""
    out = []
    pat = re.compile(regex)
    for fn in os.listdir(dir_path):
        m = pat.match(fn)
        if m:
            out.append((m.groups(), os.path.join(dir_path, fn)))
    out.sort(key=lambda kv: kv[0])
    return out


def load_send(modalities: Sequence[str], base_dir: str, subset: str,
              linguistic_variant: str = "glove",
              use_native: bool = True) -> SendDataset:
    """Load aligned SENDv1 sequences for the given modalities.

    modalities: subset of {linguistic, emotient, image, acoustic}; `ratings`
    is always added (reference datasets.py:281-282).  Each modality also gets
    a timer array from its own file's timestamp column.  use_native: read
    with the native parser where it can (float32 timers), else the Python
    path alone.
    """
    mods = [m for m in modalities if m != "ratings"] + ["ratings"]
    specs = {m: SCHEMA["linguistic_bert" if m == "linguistic"
                       and linguistic_variant == "bert" else m]
             for m in mods}

    discovered = {}
    for m, spec in specs.items():
        d = os.path.join(base_dir, spec.subdir.format(subset=subset))
        discovered[m] = _discover(d, spec.regex)

    seq_ids = [sid for sid, _ in discovered[mods[0]]]
    for m in mods:
        ids_m = [sid for sid, _ in discovered[m]]
        if len(ids_m) != len(seq_ids):
            raise ValueError(
                f"Number of files ({len(ids_m)}) do not match for {m}.")
        if ids_m != seq_ids:
            raise ValueError(f"Sequence IDs do not match for {m}.")

    data = {m: [] for m in mods}
    timers = {m: [] for m in mods}
    lengths = []
    n_native = 0
    for i in range(len(seq_ids)):
        seq_len = None
        for m, spec in specs.items():
            path = discovered[m][i][1]
            got = _load_native(path, spec) if use_native else None
            n_native += got is not None
            feats, t = got if got is not None else _load_columns(path, spec)
            data[m].append(feats)
            timers[m].append(t)
            if spec.fmt == "tsv":
                # the reference takes seq length from the tsv modality
                # (datasets.py:92-95)
                seq_len = len(feats)
        if seq_len is None:
            seq_len = len(data[mods[0]][-1])
        lengths.append(seq_len)

    n_files = len(seq_ids) * len(specs)
    if use_native and not native_loader.available():
        why = f" (native parser unavailable: {native_loader.build_error})"
    else:
        why = ""
    log.info("SENDv1 %s: %d of %d files read by the native parser "
             "(native/fastload.cpp), %d by the Python parser%s", subset,
             n_native, n_files, n_files - n_native, why)
    return SendDataset(tuple(mods), seq_ids, data, timers, lengths)
