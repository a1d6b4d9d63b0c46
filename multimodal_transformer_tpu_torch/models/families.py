"""The five model families.

Counterpart of `multimodal_transformer_tpu/models/families.py`.  Every family
is an nn.Module whose parameter names flatten to the JAX package's tree, and
whose forward is

    forward(inputs, mask, *, mask_mode=None, seeds=None, plain=False)

with inputs mod -> [B, W, F, D] windows and mask [B, W, 1]; it returns
[B, W, 1].  mask_mode defaults to the config's; plain=True runs the plain
PyTorch front end, encoders and MFN recurrence on any device (the reference
that the CUDA path is checked against).  seeds (ops/seeds.py) selects a
training forward, which only the multi-modality MFT has so far.

  MFT      per modality CNN+Highway -> Linear embed -> 6-layer encoder ->
           MFN -> head; one modality: UniTransformer.
  SFT      CNN+Highway -> concat -> Linear(total -> 512) + tanh ->
           NLPTransformer (UniTransformer with the MLP embed); one
           modality: UniTransformer.
  B1-LSTM  CNN+Highway (ReLU on the projection; not in the "legacy"
           variant) -> concat -> MultiLSTM.
  B2-Trans CNN+Highway -> concat -> UniFullTransformer.
  B3-MFN   like MFT without the per-modality encoders: Linear embed -> MFN;
           one modality: UniTransformer.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.attention import Encoder, encoder_stack, encoder_stack_plain
from ..ops.mfn_core import MFN, mfn_scan
from ..utils.init import make_linear
from .config import FAMILIES, MFT_EMBED_DIM, ModelConfig
from .frontend import add_frontend, frontend_apply
from .heads import MultiLSTM, UniFullTransformer, UniTransformer

ENCODER_HEADS, ENCODER_FF, ENCODER_LAYERS = 8, 128, 6
SFT_FUSE_EMBED = 512


class _Family(nn.Module):
    """The per-modality CNN + Highway front end shared by every family."""

    relu_proj = False

    def __init__(self, cfg: ModelConfig, gen: torch.Generator | None):
        super().__init__()
        self.cfg = cfg
        add_frontend(self, cfg.modalities, cfg.mod_dimension,
                     cfg.window_embed_size, gen)

    def front(self, inputs, seeds, plain: bool) -> dict:
        if seeds is not None and not self.trains:
            raise NotImplementedError(
                f"training of {self.cfg.family} with modalities "
                f"{self.cfg.modalities} is not ported yet (ROADMAP Queue 1)")
        return frontend_apply(self, inputs, self.cfg.modalities,
                              None if seeds is None else seeds.front,
                              relu_proj=self.relu_proj, plain=plain)

    @property
    def trains(self) -> bool:
        return False

    def fused(self, outs) -> torch.Tensor:
        return torch.cat([outs[m] for m in self.cfg.modalities], dim=-1)


class MFTHead(nn.Module):
    """Per modality Linear embed (+ encoder when with_encoders) and the MFN."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator | None,
                 with_encoders: bool = True):
        super().__init__()
        for m in cfg.modalities:
            setattr(self, f"embed_{m}", make_linear(cfg.window_embed_size[m],
                                                    MFT_EMBED_DIM[m], gen))
            if with_encoders:
                setattr(self, f"transformer_{m}",
                        Encoder(MFT_EMBED_DIM[m], ENCODER_FF, ENCODER_LAYERS,
                                gen))
        self.mfn = MFN(cfg.modalities, MFT_EMBED_DIM, output_dim=1, gen=gen)


class MFT(_Family):
    """The MFT; with one modality its head is the UniTransformer."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator | None = None):
        super().__init__(cfg, gen)
        self.Transformer = (MFTHead(cfg, gen) if len(cfg.modalities) > 1
                            else UniTransformer(cfg.total_embed_size, gen=gen))

    @property
    def trains(self) -> bool:
        return len(self.cfg.modalities) > 1

    def forward(self, inputs, mask, *, mask_mode: str | None = None,
                seeds=None, plain: bool = False):
        mods = self.cfg.modalities
        mask_mode = mask_mode or self.cfg.mask_mode
        outs = self.front(inputs, seeds, plain)
        head = self.Transformer
        if len(mods) == 1:
            return head(outs[mods[0]], mask, mask_mode=mask_mode, plain=plain)
        enc_fn = encoder_stack_plain if plain else encoder_stack
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


class SFT(_Family):
    def __init__(self, cfg: ModelConfig, gen: torch.Generator | None = None):
        super().__init__(cfg, gen)
        # with one modality the reference still creates the fusion layer
        self.fusionLayer = make_linear(cfg.total_embed_size, SFT_FUSE_EMBED,
                                       gen)
        self.Transformer = UniTransformer(
            SFT_FUSE_EMBED if len(cfg.modalities) > 1
            else cfg.total_embed_size, gen=gen)

    def forward(self, inputs, mask, *, mask_mode: str | None = None,
                seeds=None, plain: bool = False):
        mask_mode = mask_mode or self.cfg.mask_mode
        outs = self.front(inputs, seeds, plain)
        if len(self.cfg.modalities) == 1:
            return self.Transformer(outs[self.cfg.modalities[0]], mask,
                                    mask_mode=mask_mode, plain=plain)
        fused = torch.tanh(self.fusionLayer(self.fused(outs)))
        return self.Transformer(fused, mask, mask_mode=mask_mode, plain=plain,
                                embed_is_mlp=True)


class B1LSTM(_Family):
    """variant "default": the B1 Highway (ReLU on the projection) and the
    MultiLSTM at embed 512; "legacy": the plain Highway and embed 128."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator | None = None):
        super().__init__(cfg, gen)
        legacy = cfg.variant == "legacy"
        self.relu_proj = not legacy
        self.LSTM = MultiLSTM(cfg.total_embed_size,
                              embed_dim=128 if legacy else 512, h_dim=256,
                              gen=gen)

    def forward(self, inputs, mask, *, mask_mode: str | None = None,
                seeds=None, plain: bool = False):
        outs = self.front(inputs, seeds, plain)
        return self.LSTM(self.fused(outs), mask,
                         mask_mode=mask_mode or self.cfg.mask_mode)


class B2Trans(_Family):
    def __init__(self, cfg: ModelConfig, gen: torch.Generator | None = None):
        super().__init__(cfg, gen)
        self.Transformer = UniFullTransformer(cfg.total_embed_size, gen=gen)

    def forward(self, inputs, mask, *, mask_mode: str | None = None,
                seeds=None, plain: bool = False):
        outs = self.front(inputs, seeds, plain)
        return self.Transformer(self.fused(outs), mask,
                                mask_mode=mask_mode or self.cfg.mask_mode,
                                plain=plain)


class B3MFN(_Family):
    def __init__(self, cfg: ModelConfig, gen: torch.Generator | None = None):
        super().__init__(cfg, gen)
        self.Transformer = (MFTHead(cfg, gen, with_encoders=False)
                            if len(cfg.modalities) > 1
                            else UniTransformer(cfg.total_embed_size, gen=gen))

    def forward(self, inputs, mask, *, mask_mode: str | None = None,
                seeds=None, plain: bool = False):
        mods = self.cfg.modalities
        outs = self.front(inputs, seeds, plain)
        head = self.Transformer
        if len(mods) == 1:
            return head(outs[mods[0]], mask,
                        mask_mode=mask_mode or self.cfg.mask_mode, plain=plain)
        mfn_in = {m: getattr(head, f"embed_{m}")(outs[m]) for m in mods}
        return mfn_scan(head.mfn, mfn_in, plain=plain) * mask


FAMILY_MODULES = {"MFT": MFT, "SFT": SFT, "B1-LSTM": B1LSTM,
                  "B2-Trans": B2Trans, "B3-MFN": B3MFN}


def build_model(cfg: ModelConfig, *,
                generator: torch.Generator | None = None) -> nn.Module:
    """The family's module on the CPU, weights drawn from `generator`
    (PyTorch's own default init when it is None)."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}; expected one of "
                         f"{FAMILIES}")
    return FAMILY_MODULES[cfg.family](cfg, generator)
