"""Per-site dropout seeds of one MFT training step.

The JAX package turns one PRNG key into a uint32 seed per dropout site
(`jax.random.split` + `basic.hash_seed`): one per modality for the front end,
an [N, 4] table per encoder (attention probabilities, attention output, FFN
hidden, FFN output of each layer; `ops/pallas/encoder.py dropout_seed_table`),
a [T, 2] table for the MFN's gamma1/gamma2 hiddens (`ops/mfn_core.py`) and
one for the output head (`fold_in(rng, 7)`).  The port takes those seeds as
a value, so it needs no JAX: a trainer draws them from a `torch.Generator`,
and a test can build the very seeds the JAX package would use from a key.

Seeds are uint32 values held in int64 CPU tensors (or Python ints); the
kernels' wrappers pass them to the card themselves.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class DropoutSeeds:
    front: Dict[str, int]             # modality -> seed of the [B, W, E] site
    encoder: Dict[str, torch.Tensor]  # modality -> [N, 4] int64
    mfn: torch.Tensor                 # [T, 2] int64 (gamma1, gamma2 per step)
    out: int                          # seed of the head's [T, B, 64] site

    @staticmethod
    def draw(mods: Sequence[str], n_layers: int, T: int,
             generator: torch.Generator) -> "DropoutSeeds":
        """Fresh uniform uint32 seeds for every site, from `generator`."""
        def u32(*shape):
            return torch.randint(0, 2 ** 32, shape, generator=generator,
                                 dtype=torch.int64)

        front = {m: int(u32(1)) for m in mods}
        encoder = {m: u32(n_layers, 4) for m in mods}
        return DropoutSeeds(front, encoder, u32(T, 2), int(u32(1)))
