"""Synthetic mini-SENDv1 fixture generator (numpy only).

Copy of `multimodal_transformer_tpu/data/synthetic.py`: the same arguments
write the same bytes.  Writes a directory tree with the same layout,
filename patterns, file formats, and column schemas as the real SENDv1
dataset (as wired in reference MFT/datasets.py:244-280), so the full data
layer — regex discovery, table parsing, column slicing, windowing — can be
exercised hermetically in tests and on a machine without SENDv1.

Ratings are generated as a smooth random walk that is a noisy function of a
latent signal also injected (weakly) into every feature stream, so models can
actually fit the fixture (useful for end-to-end train smoke tests where CCC
should rise above zero).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np

# 20 FACS action units — matches the width of the reference's AU1:AU43 slice.
AU_NAMES = ["AU1", "AU2", "AU4", "AU5", "AU6", "AU7", "AU9", "AU10", "AU12",
            "AU14", "AU15", "AU17", "AU18", "AU20", "AU23", "AU24", "AU25",
            "AU26", "AU28", "AU43"]

ACOUSTIC_FIRST = " F0semitoneFrom27.5Hz_sma3nz_amean"
ACOUSTIC_LAST = " equivalentSoundLevel_dBp"


def _acoustic_cols(dim: int):
    mid = [f" egemaps_feat{i}" for i in range(dim - 2)]
    return [ACOUSTIC_FIRST] + mid + [ACOUSTIC_LAST]


def _write_table(path, header, rows, sep=","):
    with open(path, "w") as f:
        f.write(sep.join(header) + "\n")
        for row in rows:
            f.write(sep.join(f"{v:.6f}" if isinstance(v, float) else str(v)
                             for v in row) + "\n")


def generate_synthetic_send(base_dir: str, subsets: Dict[str, int],
                            duration_s: float = 60.0,
                            dims: Optional[Dict[str, int]] = None,
                            modalities: Sequence[str] = ("linguistic",
                                                         "emotient", "image",
                                                         "acoustic"),
                            seed: int = 0,
                            linguistic_variant: str = "glove") -> None:
    """Create base_dir/{features,ratings}/{subset}/... fixture files.

    subsets: e.g. {"Train": 6, "Valid": 2, "Test": 2} (videos per subset).
    dims: raw feature dims; defaults to the real schema
          (linguistic 300 / bert 1024, emotient 20, image 1000, acoustic 88).
    """
    if dims is None:
        dims = {"linguistic": 1024 if linguistic_variant == "bert" else 300,
                "emotient": 20, "image": 1000, "acoustic": 88}

    # Per-(subset, video[, channel]) derived RNGs so that regenerating any
    # modality subset (e.g. adding the BERT linguistic tree later) reproduces
    # identical durations, latents, timers, and ratings.
    import zlib

    def _rs(*key):
        h = zlib.crc32(repr((seed,) + key).encode())  # process-stable
        return np.random.RandomState(h & 0x7FFFFFFF)

    rates = {"linguistic": 0.55, "emotient": 10.0, "image": 1.7,
             "acoustic": 2.0, "ratings": 2.0}

    for subset, n_videos in subsets.items():
        feat_base = os.path.join(base_dir, "features", subset)
        ling_dir = ("linguistic-word-level-bert"
                    if linguistic_variant == "bert"
                    else "linguistic-word-level")
        paths = {
            "linguistic": os.path.join(feat_base, ling_dir),
            "emotient": os.path.join(feat_base, "emotient"),
            "image": os.path.join(feat_base, "image"),
            "acoustic": os.path.join(feat_base, "acoustic-egemaps"),
            "ratings": os.path.join(base_dir, "ratings", subset,
                                    "observer_EWE"),
        }
        for m in list(modalities) + ["ratings"]:
            os.makedirs(paths[m], exist_ok=True)

        for v in range(n_videos):
            sid, vid = 100 + v, 1 + (v % 8)
            rs_v = _rs(subset, v, "latent")
            dur = duration_s * (0.75 + 0.5 * rs_v.rand())
            # latent valence signal: smooth random walk in [0, 1]
            t_lat = np.arange(0.0, dur, 0.25)
            walk = np.cumsum(rs_v.randn(len(t_lat))) * 0.05
            walk = 0.5 + 0.4 * np.tanh(walk - walk.mean())

            def latent_at(ts):
                return np.interp(ts, t_lat, walk)

            for m in modalities:
                rs_m = _rs(subset, v, m)
                ts = np.arange(0.0, dur, 1.0 / rates[m])
                feats = rs_m.randn(len(ts), dims[m]).astype(np.float32) * 0.3
                # inject the latent into the first few dims strongly enough to
                # survive the CNN+maxpool front-end — the fixture must be
                # learnable for end-to-end train smoke tests
                k = max(1, dims[m] // 4)
                feats[:, :k] += latent_at(ts).astype(np.float32)[:, None] * 2.0
                if m == "linguistic":
                    prefix = "bert" if linguistic_variant == "bert" else "glove"
                    header = ["time-offset"] + [f"{prefix}{i}"
                                                for i in range(dims[m])]
                    rows = [[float(ts[i])] + feats[i].tolist()
                            for i in range(len(ts))]
                    _write_table(os.path.join(
                        paths[m], f"ID{sid}_vid{vid}_aligned.tsv"),
                        header, rows, sep="\t")
                elif m == "emotient":
                    assert dims[m] == len(AU_NAMES), \
                        "emotient fixture requires dim 20"
                    header = ["Frametime"] + AU_NAMES
                    # sprinkle NaNs: the reference scrubs them (train.py:377-384)
                    feats[rs_m.rand(*feats.shape) < 0.01] = np.nan
                    rows = [[float(ts[i])] + feats[i].tolist()
                            for i in range(len(ts))]
                    _write_table(os.path.join(
                        paths[m], f"ID{sid}_vid{vid}_emotient.txt"),
                        header, rows)
                elif m == "image":
                    header = ["Frametime"] + [f"vector{i}"
                                              for i in range(dims[m])]
                    rows = [[float(ts[i])] + feats[i].tolist()
                            for i in range(len(ts))]
                    _write_table(os.path.join(
                        paths[m], f"ID{sid}_vid{vid}_image.ssv"),
                        header, rows, sep=" ")
                elif m == "acoustic":
                    header = [" frameTime"] + _acoustic_cols(dims[m])
                    rows = [[float(ts[i])] + feats[i].tolist()
                            for i in range(len(ts))]
                    _write_table(os.path.join(
                        paths[m], f"ID{sid}_vid{vid}_acoustic.csv"),
                        header, rows)

            ts = np.arange(0.0, dur, 1.0 / rates["ratings"])
            ewe = np.clip(latent_at(ts)
                          + _rs(subset, v, "ratings").randn(len(ts)) * 0.02,
                          0, 1) * 100
            _write_table(os.path.join(paths["ratings"],
                                      f"results_{sid}_{vid}.csv"),
                         ["time", "evaluatorWeightedEstimate"],
                         [[float(ts[i]), float(ewe[i])]
                          for i in range(len(ts))])
