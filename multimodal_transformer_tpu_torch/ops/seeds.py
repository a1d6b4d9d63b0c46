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
first row times the site's elements per row; the MFN head's `out` site
indexes a time-major hidden, which no shift can express, so it carries the
rows (first row, global rows) to `ops/mfn_core.mfn_head` instead.

The port takes the seeds as a value, so it needs no JAX: a trainer draws
them from a `torch.Generator`, and a test can build the very seeds the JAX
package would use from a key.

Seeds are uint32 values held in int64 CPU tensors (or Python ints); the
kernels' wrappers pass them to the card themselves.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

HASH_MUL = 0x9E3779B1  # the hash's first multiply (ops/basic.py, csrc/common.cuh)
_M32 = 0xFFFFFFFF


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
    front_widths: Tuple[int, ...] = ()  # E of each front end's [B, W, E]
    # (d_model, d_ff, heads) of each encoder, in `encoders` order
    encoder_dims: Tuple[Tuple[int, int, int], ...] = ()
    gamma_widths: Tuple[int, int] = (0, 0)  # the [B, hg_k] gamma hiddens
    embed_width: int = 0              # the [B, T, width] embed site
    decoder_width: int = 0            # B1's [B, T, width] decoder site


@dataclasses.dataclass(frozen=True)
class DropoutSeeds:
    front: Dict[str, int]             # modality -> seed of the [B, W, E] site
    encoder: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    mfn: Optional[torch.Tensor] = None  # [T, 2] int64 (gamma1, gamma2)
    out: Optional[int] = None         # seed of the MFN head's [T, B, 64] site
    embed: Optional[int] = None
    decoder: Optional[int] = None
    # (first row, global rows) of a data-parallel rank, for the `out` site
    rows: Optional[Tuple[int, int]] = None

    def for_rows(self, sites: DropoutSites, r0: int, rows: int,
                 T: int) -> "DropoutSeeds":
        """The seeds of a rank that runs rows [r0, r0 + local) of a padded
        global batch of `rows` rows and T steps: each batch-major site's
        seed shifted by r0 times the site's elements per row, so that the
        rank's masks are the global batch's masks at its rows."""
        def shift(seed, per_row):
            if seed is None:
                return None
            return (int(seed) + r0 * per_row * HASH_MUL) & _M32

        def shift_cols(table, per_row):
            d = torch.tensor([r0 * n * HASH_MUL & _M32 for n in per_row],
                             dtype=torch.int64)
            return (table.to(torch.int64) + d) & _M32

        front = {m: shift(self.front[m], T * e)
                 for m, e in zip(sites.front, sites.front_widths)}
        encoder = {name: shift_cols(self.encoder[name],
                                    (h * T * T, T * d, T * f, T * d))
                   for name, (d, f, h) in zip(sites.encoders,
                                              sites.encoder_dims)}
        mfn = (None if self.mfn is None
               else shift_cols(self.mfn, sites.gamma_widths))
        return DropoutSeeds(front, encoder, mfn, self.out,
                            shift(self.embed, T * sites.embed_width),
                            shift(self.decoder, T * sites.decoder_width),
                            (r0, rows))

    @staticmethod
    def draw(sites: DropoutSites, T: int,
             generator: torch.Generator) -> "DropoutSeeds":
        """Fresh uniform uint32 seeds for every site of `sites`, from
        `generator`, in a fixed order (front, encoders, MFN, out, embed,
        decoder)."""
        def u32(*shape):
            return torch.randint(0, 2 ** 32, shape, generator=generator,
                                 dtype=torch.int64)

        front = {m: int(u32(1)) for m in sites.front}
        encoder = {e: u32(sites.n_layers, 4) for e in sites.encoders}
        mfn = u32(T, 2) if sites.mfn else None
        out = int(u32(1)) if sites.mfn else None
        embed = int(u32(1)) if sites.embed else None
        decoder = int(u32(1)) if sites.decoder else None
        return DropoutSeeds(front, encoder, mfn, out, embed, decoder)
