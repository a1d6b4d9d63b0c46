"""Model/family configuration, mirroring the reference's hardcoded main() dicts.

Sources:
  MFT:  mod_dimension / window_size / window_embed_size at
        reference MFT/train.py:550-552 (acoustic window_embed swept over
        {88, 44} via A_dim at train.py:539).
  SFT / B2-Trans / B3-MFN: window_embed hardcoded
        {'linguistic':300,'emotient':20,'acoustic':256,'image':256}
        (SFT/models.py:90, B2-Trans/models.py:90, B3-MFN/models.py:90);
        mod_dimension/window_size at SFT/train.py:533-535 etc.
  B1-LSTM: BERT-1024 linguistic features; window_embed linguistic=1024
        (B1-LSTM/models.py:88); mod_dimension/window_size at
        B1-LSTM/train.py:528-529 — note ratings window = 5 s.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

FAMILIES = ("MFT", "SFT", "B1-LSTM", "B2-Trans", "B3-MFN")

# reference MFT/multiTransformer.py:260
MFT_EMBED_DIM = {"linguistic": 256, "emotient": 16, "acoustic": 256,
                 "image": 256}

_COMMON_MOD_DIMENSION = {"linguistic": 300, "emotient": 20, "acoustic": 88,
                         "image": 1000}
_COMMON_WINDOW_SIZE = {"linguistic": 5, "emotient": 1, "acoustic": 1,
                       "image": 1, "ratings": 1}
_SFT_WINDOW_EMBED = {"linguistic": 300, "emotient": 20, "acoustic": 256,
                     "image": 256}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    family: str
    modalities: Tuple[str, ...]
    mod_dimension: Dict[str, int]
    window_size: Dict[str, int]
    window_embed_size: Dict[str, int]
    # "query" replicates the reference's row-only attention mask (bit-parity
    # at bs=1); "key_query" is padding-invariant for bucketed TPU eval.
    mask_mode: str = "query"
    # B1-LSTM "legacy": the MFT-style MultiLSTM head (embed_dim=128,
    # h_dim=256, Dropout(0.1) embed, no decoder dropout, no Highway ReLU) —
    # the flavor of the surviving reference checkpoint
    # ModelSave/B1-LSTM/B1-LSTM-L.pth (weights: embed Linear(300->128),
    # decoder Linear(256->128)->Linear(128->1)).
    variant: str = "default"

    @property
    def total_embed_size(self) -> int:
        return sum(self.window_embed_size[m] for m in self.modalities)


def modalities_from_comb(comb: str) -> Tuple[str, ...]:
    """'VAL' -> modalities in the reference's append order
    (A, V, L — reference MFT/train.py:543-549)."""
    mods = []
    if "A" in comb:
        mods.append("acoustic")
    if "V" in comb:
        mods.append("image")
    if "L" in comb:
        mods.append("linguistic")
    return tuple(mods)


def default_config(family: str, modalities, acoustic_embed: int = 88,
                   mask_mode: str = "query",
                   variant: str = "default") -> ModelConfig:
    modalities = tuple(modalities)
    if family == "MFT":
        wes = {"linguistic": 300, "emotient": 20, "acoustic": acoustic_embed,
               "image": 256}
        return ModelConfig(family, modalities, dict(_COMMON_MOD_DIMENSION),
                           dict(_COMMON_WINDOW_SIZE), wes, mask_mode)
    if family in ("SFT", "B2-Trans", "B3-MFN"):
        return ModelConfig(family, modalities, dict(_COMMON_MOD_DIMENSION),
                           dict(_COMMON_WINDOW_SIZE), dict(_SFT_WINDOW_EMBED),
                           mask_mode)
    if family == "B1-LSTM":
        if variant == "legacy":
            mod_dim = dict(_COMMON_MOD_DIMENSION)
            window_size = dict(_COMMON_WINDOW_SIZE, ratings=5)
            wes = dict(_SFT_WINDOW_EMBED)
            return ModelConfig(family, modalities, mod_dim, window_size, wes,
                               mask_mode, variant)
        mod_dim = dict(_COMMON_MOD_DIMENSION, linguistic=1024)
        window_size = dict(_COMMON_WINDOW_SIZE, ratings=5)
        wes = {"linguistic": 1024, "emotient": 20, "acoustic": 256,
               "image": 256}
        return ModelConfig(family, modalities, mod_dim, window_size, wes,
                           mask_mode)
    raise ValueError(f"unknown family {family!r}; expected one of {FAMILIES}")
