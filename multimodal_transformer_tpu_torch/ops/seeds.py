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
family in models/families.py); the others stay None.  The port takes the
seeds as a value, so it needs no JAX: a trainer draws them from a
`torch.Generator`, and a test can build the very seeds the JAX package would
use from a key.

Seeds are uint32 values held in int64 CPU tensors (or Python ints); the
kernels' wrappers pass them to the card themselves.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class DropoutSites:
    """The dropout sites of one configuration's training forward."""
    front: Tuple[str, ...]            # modalities
    encoders: Tuple[str, ...] = ()    # encoder names, an [N, 4] table each
    n_layers: int = 6
    mfn: bool = False                 # the [T, 2] gamma table and `out`
    embed: bool = False
    decoder: bool = False


@dataclasses.dataclass(frozen=True)
class DropoutSeeds:
    front: Dict[str, int]             # modality -> seed of the [B, W, E] site
    encoder: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    mfn: Optional[torch.Tensor] = None  # [T, 2] int64 (gamma1, gamma2)
    out: Optional[int] = None         # seed of the MFN head's [T, B, 64] site
    embed: Optional[int] = None
    decoder: Optional[int] = None

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
