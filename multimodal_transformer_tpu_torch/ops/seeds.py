"""Per-site dropout seeds of one training step.

The JAX package turns one PRNG key into a uint32 seed per dropout site
(`jax.random.split` + `basic.hash_seed`), along each family's own key tree
(`models/families.py`, `models/heads.py` there):

  * `front`: one per modality, the front end's [B, W, E] site;
  * `encoder`: an [N, 4] table per encoder (attention probabilities,
    attention output, FFN hidden, FFN output of each layer;
    `ops/pallas/encoder.py dropout_seed_table`), keyed by the encoder's
    attribute name in its head: `transformer_<modality>` in the
    multi-modality MFT, `encoder` in `UniTransformer` and
    `UniFullTransformer`;
  * `mfn`: a [T, 2] table for the MFN's gamma1/gamma2 hiddens
    (`ops/mfn_core.py`), and `out`, the seed of its head (`fold_in(rng, 7)`);
  * `embed`: the input dropout of the SFT's MLP embed and of B1's
    `MultiLSTM`; `decoder`: B1's decoder dropout.

A configuration uses the sites its module lists (`dropout_sites()` of every
family in models/families.py); the others stay None.

Data parallelism (parallel/mesh.py) runs a contiguous block of a padded
global batch's rows on each rank, and a rank must drop exactly the elements
that the global batch drops at those rows.  The hash injects the seed after
one multiply, h = idx * 0x9E3779B1 + seed, so a position offset is a seed
offset: hash(idx + d, s) = hash(idx, s + d * 0x9E3779B1) mod 2**32.
`DropoutSeeds.for_rows` shifts every batch-major site's seed by the rank's
first row times the site's elements per row.  A threefry mask's bits at a
flat position depend only on the key and the position, so a rank's rows
of a batch-major site are one range of counters from the same product:
`for_rows` wraps each such site's keys as `prng.RowKeys` (key, first row,
global rows), and kernel T draws that range.  The MFN head's `out` site
indexes a time-major hidden, which neither a shift nor one range can
express, so on both streams it carries the rows (first row, global rows)
to `ops/mfn_core.mfn_head` instead.

`DropoutSeeds.from_key(sites, key, T)` derives every site's seed from a
step's key without JAX: the module that listed the sites splits the key
along its JAX apply's key tree (`sites.split_keys`, each family's and
head's `dropout_keys` in models/, from `encoder_keys` and `mfn_keys`
below), and the keys are hashed; the Engine's key of a step is
`fold_in(PRNGKey(epoch), batch_num)` (utils/prng.py), under the
Engine's key implementation (threefry keys of 2 words; rbg keys of 4, the
JAX package's `--fast_rng`).  With impl="threefry" the sites keep their
keys instead of hashing them (the JAX package's "threefry" dropout,
`jax.random.bernoulli` at every site): the tables are then [N, 4, W] and
[T, 2, W] numpy uint32 keys of W words, and each site's mask is drawn by
kernel T (threefry keys) or kernel P (rbg keys).  With impl="hash4" the
seeds are the hash's and `DropoutSeeds.hash4` is set: the scalar sites'
seeds are `ops/basic.py Hash4Seed`s, the encoders' tables stay int64 and
the encoders read the stream from the flag; the MFN's gamma table draws
the per-element bits under both hash streams, as in the JAX package.

On the "hash4" stream a multi-bit site (last axis w, w % 4 == 0) hashes
the counter row * w/4 + c % (w/4), not the flat position, so `for_rows`
shifts its seed by r0 times the site's counters per batch row, a quarter
of its elements; a site that falls back to the per-element bits (w % 4
!= 0, the attention probabilities at T % 4 != 0) keeps the hash's shift.
The port still takes the seeds as a value, and a trainer may pass any
(`Engine(seed_fn=...)`).

Hash seeds are uint32 values held in int64 CPU tensors (or Python ints);
the kernels' wrappers pass them to the card themselves.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..utils import prng
from .basic import Hash4Seed

HASH_MUL = 0x9E3779B1  # the hash's first multiply (ops/basic.py, csrc/common.cuh)
_M32 = 0xFFFFFFFF
DROPOUT_IMPLS = ("hash", "hash4", "threefry")


def encoder_keys(keys, n_layers: int) -> np.ndarray:
    """An encoder's [..., N, 4, W] table of keys: split N a layer, then 4
    a site (the JAX package's ops/pallas/encoder.py dropout_seed_table)."""
    return prng.split(prng.split(keys, n_layers), 4)


def mfn_keys(key, T: int) -> Tuple[np.ndarray, np.ndarray]:
    """The MFN's [T, 2, W] gamma keys, split(split(key, T), 2), and its
    head's `out` key, fold_in(key, 7) (ops/mfn_core.py there)."""
    return prng.split(prng.split(key, T), 2), prng.fold_in(key, 7)


@dataclasses.dataclass(frozen=True)
class DropoutSites:
    """The dropout sites of one configuration's training forward, and the
    widths that `DropoutSeeds.for_rows` needs: each site's elements per
    batch row and time step."""
    front: Tuple[str, ...]            # modalities
    encoders: Tuple[str, ...] = ()    # encoder names, an [N, 4] table each
    n_layers: int = 6
    mfn: bool = False                 # the [T, 2] gamma table and `out`
    embed: bool = False
    decoder: bool = False
    # the module's dropout_keys(key, T): the keys of these sites from a
    # step's key, along its JAX apply's key tree
    split_keys: Optional[Callable[..., "DropoutSeeds"]] = None
    front_widths: Tuple[int, ...] = ()  # E of each front end's [B, W, E]
    # (d_model, d_ff, heads) of each encoder, in `encoders` order
    encoder_dims: Tuple[Tuple[int, int, int], ...] = ()
    gamma_widths: Tuple[int, int] = (0, 0)  # the [B, hg_k] gamma hiddens
    embed_width: int = 0              # the [B, T, width] embed site
    decoder_width: int = 0            # B1's [B, T, width] decoder site


@dataclasses.dataclass(frozen=True)
class DropoutSeeds:
    # hash seeds (ints, int64 tables; Hash4Seed at the scalar sites on the
    # hash4 stream) or, on the threefry stream, keys (numpy uint32 [W], tables
    # [N, 4, W] and [T, 2, W]; prng.RowKeys of them on a data-parallel
    # rank, `for_rows`)
    front: Dict[str, int]             # modality -> seed of the [B, W, E] site
    encoder: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    mfn: Optional[torch.Tensor] = None  # [T, 2] int64 (gamma1, gamma2)
    out: Optional[int] = None         # seed of the MFN head's [T, B, 64] site
    embed: Optional[int] = None
    decoder: Optional[int] = None
    # (first row, global rows) of a data-parallel rank, for the `out` site
    rows: Optional[Tuple[int, int]] = None
    hash4: bool = False  # the "hash4" stream (the encoder tables' too)

    @staticmethod
    def from_key(sites: DropoutSites, key, T: int,
                 impl: str = "hash") -> "DropoutSeeds":
        """The seeds that the JAX apply draws from `key` at every site of
        `sites` (a step of T windows): impl "hash" hashes each site's key
        (`basic.hash_seed`), "hash4" too, on that stream (`hash4`),
        "threefry" keeps the keys.  key: a threefry or an rbg key."""
        if impl not in DROPOUT_IMPLS:
            raise ValueError(f"dropout impl must be one of {DROPOUT_IMPLS}, "
                             f"got {impl!r}")
        keys = sites.split_keys(np.asarray(key, dtype=np.uint32), T)
        if impl == "threefry":
            return keys
        return keys.hashed(hash4=impl == "hash4")

    def threefry(self) -> bool:
        """Whether the sites hold keys, threefry or rbg (the "threefry"
        stream)."""
        return any(prng.is_keys(v) for v in (
            *self.front.values(), *self.encoder.values(), self.mfn,
            self.out, self.embed, self.decoder))

    def hashed(self, hash4: bool = False) -> "DropoutSeeds":
        """These keys' hash seeds: ints, int64 tables; hash4: on that
        stream, the scalar seeds `Hash4Seed`s (the MFN's gamma table keeps
        the per-element bits on both hash streams)."""
        tag = Hash4Seed if hash4 else int

        def val(k):
            return None if k is None else tag(int(prng.hash_seed(k)))

        def table(k):
            return torch.from_numpy(prng.hash_seed(k).astype(np.int64))

        return DropoutSeeds(
            {m: val(k) for m, k in self.front.items()},
            {name: table(k) for name, k in self.encoder.items()},
            None if self.mfn is None else table(self.mfn), val(self.out),
            val(self.embed), val(self.decoder), self.rows, hash4)

    def for_rows(self, sites: DropoutSites, r0: int, rows: int,
                 T: int) -> "DropoutSeeds":
        """The seeds of a rank that runs rows [r0, r0 + local) of a padded
        global batch of `rows` rows and T steps, so that the rank's masks
        are the global batch's masks at its rows: each batch-major site's
        hash seed shifted by r0 times the site's elements per row, or its
        threefry keys wrapped as `prng.RowKeys`, whose draw starts at that
        product's counter; on the "hash4" stream a multi-bit site's seed
        by r0 times its counters per row (a quarter of its elements).  All
        keep (r0, rows) for the `out` site."""
        if self.threefry():
            def rows_of(keys):
                return None if keys is None else prng.RowKeys(keys, r0, rows)
            return DropoutSeeds(
                {m: rows_of(k) for m, k in self.front.items()},
                {name: rows_of(k) for name, k in self.encoder.items()},
                rows_of(self.mfn), self.out, rows_of(self.embed),
                rows_of(self.decoder), (r0, rows))

        hash4 = self.hash4
        tag = Hash4Seed if hash4 else int

        def counters(width, per_row):
            # a batch row's counters at a site of last axis `width`
            return per_row // 4 if hash4 and width % 4 == 0 else per_row

        def shift(seed, n):
            if seed is None:
                return None
            return tag((int(seed) + r0 * n * HASH_MUL) & _M32)

        def shift_cols(table, per_row):
            d = torch.tensor([r0 * n * HASH_MUL & _M32 for n in per_row],
                             dtype=torch.int64)
            return (table.to(torch.int64) + d) & _M32

        front = {m: shift(self.front[m], counters(e, T * e))
                 for m, e in zip(sites.front, sites.front_widths)}
        encoder = {name: shift_cols(self.encoder[name], (
            counters(T, h * T * T), counters(d, T * d), counters(f, T * f),
            counters(d, T * d)))
                   for name, (d, f, h) in zip(sites.encoders,
                                              sites.encoder_dims)}
        # the gamma sites: per-element bits on both hash streams
        mfn = (None if self.mfn is None
               else shift_cols(self.mfn, sites.gamma_widths))
        return DropoutSeeds(front, encoder, mfn, self.out,
                            shift(self.embed, counters(
                                sites.embed_width, T * sites.embed_width)),
                            shift(self.decoder, counters(
                                sites.decoder_width,
                                T * sites.decoder_width)),
                            (r0, rows), hash4)
