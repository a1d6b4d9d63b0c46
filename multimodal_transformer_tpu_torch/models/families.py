"""Model families.  This slice ports MFT with two or more modalities.

Counterpart of `multimodal_transformer_tpu/models/families.py`.  MFT: per
modality CNN + Highway -> Linear embed -> 6-layer pre-norm encoder (D=256,
h=8, d_ff=128); then the MFN across modalities and its output head; the
prediction is multiplied by the mask.  The other families, and MFT with one
modality (its UniTransformer head), are not ported yet and raise.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.attention import Encoder, encoder_stack, encoder_stack_plain
from ..ops.mfn_core import MFN, mfn_scan
from ..utils.init import init_linear
from .config import FAMILIES, MFT_EMBED_DIM, ModelConfig
from .frontend import add_frontend, frontend_apply

ENCODER_HEADS, ENCODER_FF, ENCODER_LAYERS = 8, 128, 6


class MFTHead(nn.Module):
    def __init__(self, cfg: ModelConfig, gen: torch.Generator | None = None):
        super().__init__()
        for m in cfg.modalities:
            embed = nn.Linear(cfg.window_embed_size[m], MFT_EMBED_DIM[m])
            if gen is not None:
                init_linear(embed, gen)
            setattr(self, f"embed_{m}", embed)
            setattr(self, f"transformer_{m}",
                    Encoder(MFT_EMBED_DIM[m], ENCODER_FF, ENCODER_LAYERS, gen))
        self.mfn = MFN(cfg.modalities, MFT_EMBED_DIM, output_dim=1, gen=gen)


class MFT(nn.Module):
    """The multi-modality MFT.  forward(inputs, mask) with inputs mod ->
    [B, W, F, D] and mask [B, W, 1]; returns [B, W, 1]."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator | None = None):
        super().__init__()
        if cfg.family != "MFT" or len(cfg.modalities) < 2:
            raise ValueError("MFT module needs family MFT and >= 2 modalities")
        self.cfg = cfg
        add_frontend(self, cfg.modalities, cfg.mod_dimension,
                     cfg.window_embed_size, gen)
        self.Transformer = MFTHead(cfg, gen)

    def forward(self, inputs, mask, *, mask_mode: str | None = None,
                seeds=None, plain: bool = False):
        """seeds: a DropoutSeeds (ops/seeds.py) for a training step, None
        for eval.  plain=True runs the plain PyTorch encoder and MFN
        recurrence on any device: the reference that the CUDA path is
        checked against."""
        mods = self.cfg.modalities
        mask_mode = mask_mode or self.cfg.mask_mode
        enc_fn = encoder_stack_plain if plain else encoder_stack
        outs = frontend_apply(self, inputs, mods,
                              None if seeds is None else seeds.front)
        head = self.Transformer
        mfn_in = {}
        for m in mods:
            e = getattr(head, f"embed_{m}")(outs[m])
            mfn_in[m] = enc_fn(getattr(head, f"transformer_{m}"), e, mask,
                               h=ENCODER_HEADS, mask_mode=mask_mode,
                               seeds=None if seeds is None else seeds.encoder[m])
        if seeds is None:
            pred = mfn_scan(head.mfn, mfn_in, plain=plain)
        else:
            pred = mfn_scan(head.mfn, mfn_in, seeds.mfn, seeds.out, plain=plain)
        return pred * mask


def build_model(cfg: ModelConfig, *,
                generator: torch.Generator | None = None) -> nn.Module:
    """The family's module on the CPU, weights drawn from `generator`
    (PyTorch's own default init when it is None)."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}; expected one of "
                         f"{FAMILIES}")
    if cfg.family != "MFT":
        raise NotImplementedError(
            f"family {cfg.family} is not ported yet (ROADMAP Queue 1, item 7)")
    if len(cfg.modalities) < 2:
        raise NotImplementedError(
            "MFT with one modality needs the UniTransformer head, which is "
            "not ported yet (ROADMAP Queue 1, item 7)")
    return MFT(cfg, generator)
