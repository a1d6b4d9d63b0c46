"""The five model families.

Counterpart of `multimodal_transformer_tpu/models/families.py`.  Every family
is an nn.Module whose parameter names flatten to the JAX package's tree, and
whose forward is

    forward(inputs, mask, *, mask_mode=None, seeds=None, plain=False,
            encoder_backward="perlayer")

with inputs mod -> [B, W, F, D] windows and mask [B, W, 1]; it returns
[B, W, 1].  mask_mode defaults to the config's; plain=True runs the plain
PyTorch front end, encoders and MFN recurrence on any device (the reference
that the CUDA path is checked against).  seeds (ops/seeds.py) selects the
training forward, with hash dropout at every site of the family's JAX
apply; `dropout_sites()` lists those sites, so that a trainer draws seeds
for exactly them.  encoder_backward picks the encoders' training backward
on the card: "perlayer" (kernel 4 per layer) or "stack" (kernel 5).

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

import dataclasses

import torch
from torch import nn

from ..ops.attention import Encoder
from ..ops.mfn_core import MFN, mfn_scan
from ..ops.seeds import DropoutSites
from ..utils.init import make_linear
from .config import FAMILIES, MFT_EMBED_DIM, ModelConfig
from .frontend import add_frontend, frontend_apply
from .heads import (HEADS, MultiLSTM, UniFullTransformer, UniTransformer,
                    encode)

ENCODER_FF, ENCODER_LAYERS = 128, 6
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
        return frontend_apply(self, inputs, self.cfg.modalities,
                              None if seeds is None else seeds.front,
                              relu_proj=self.relu_proj, plain=plain)

    def dropout_sites(self) -> DropoutSites:
        """The head's sites: one encoder, as every single-modality head and
        the SFT/B2 heads have."""
        return self._sites(encoders=("encoder",))

    def _sites(self, encoders=(), **kw) -> DropoutSites:
        """DropoutSites with the front ends' and the named encoders' widths
        (each encoder an attribute of the head `Transformer`)."""
        mods = self.cfg.modalities
        dims = []
        for name in encoders:
            w_1 = getattr(self.Transformer, name).layers[0].feed_forward.w_1
            dims.append((w_1.in_features, w_1.out_features, HEADS))
        return DropoutSites(
            mods, tuple(encoders), ENCODER_LAYERS,
            front_widths=tuple(self.cfg.window_embed_size[m] for m in mods),
            encoder_dims=tuple(dims), **kw)

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


def _mfn_sites(head: MFTHead) -> dict:
    mfn = head.mfn
    return {"mfn": True, "gamma_widths": (mfn.gamma1_fc1.out_features,
                                          mfn.gamma2_fc1.out_features)}


def _mfn_pred(head: MFTHead, mfn_in, mask, seeds, plain: bool):
    if seeds is None:
        return mfn_scan(head.mfn, mfn_in, plain=plain) * mask
    return mfn_scan(head.mfn, mfn_in, seeds.mfn, seeds.out, plain=plain,
                    out_rows=seeds.rows) * mask


class MFT(_Family):
    """The MFT; with one modality its head is the UniTransformer."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator | None = None):
        super().__init__(cfg, gen)
        self.Transformer = (MFTHead(cfg, gen) if len(cfg.modalities) > 1
                            else UniTransformer(cfg.total_embed_size, gen=gen))

    def dropout_sites(self) -> DropoutSites:
        mods = self.cfg.modalities
        if len(mods) == 1:
            return super().dropout_sites()
        return self._sites(tuple(f"transformer_{m}" for m in mods),
                           **_mfn_sites(self.Transformer))

    def forward(self, inputs, mask, *, mask_mode: str | None = None,
                seeds=None, plain: bool = False,
                encoder_backward: str = "perlayer"):
        mods = self.cfg.modalities
        mask_mode = mask_mode or self.cfg.mask_mode
        outs = self.front(inputs, seeds, plain)
        head = self.Transformer
        if len(mods) == 1:
            return head(outs[mods[0]], mask, mask_mode=mask_mode, plain=plain,
                        seeds=seeds, encoder_backward=encoder_backward)
        mfn_in = {}
        for m in mods:
            name = f"transformer_{m}"
            mfn_in[m] = encode(getattr(head, name),
                               getattr(head, f"embed_{m}")(outs[m]), mask,
                               mask_mode, plain,
                               None if seeds is None else seeds.encoder[name],
                               encoder_backward)
        return _mfn_pred(head, mfn_in, mask, seeds, plain)


class SFT(_Family):
    def __init__(self, cfg: ModelConfig, gen: torch.Generator | None = None):
        super().__init__(cfg, gen)
        # with one modality the reference still creates the fusion layer
        self.fusionLayer = make_linear(cfg.total_embed_size, SFT_FUSE_EMBED,
                                       gen)
        self.Transformer = UniTransformer(
            SFT_FUSE_EMBED if len(cfg.modalities) > 1
            else cfg.total_embed_size, gen=gen)

    def dropout_sites(self) -> DropoutSites:
        sites = super().dropout_sites()
        if len(self.cfg.modalities) == 1:
            return sites
        return dataclasses.replace(sites, embed=True,
                                   embed_width=self.fusionLayer.out_features)

    def forward(self, inputs, mask, *, mask_mode: str | None = None,
                seeds=None, plain: bool = False,
                encoder_backward: str = "perlayer"):
        mask_mode = mask_mode or self.cfg.mask_mode
        outs = self.front(inputs, seeds, plain)
        kw = dict(mask_mode=mask_mode, plain=plain, seeds=seeds,
                  encoder_backward=encoder_backward)
        if len(self.cfg.modalities) == 1:
            return self.Transformer(outs[self.cfg.modalities[0]], mask, **kw)
        fused = torch.tanh(self.fusionLayer(self.fused(outs)))
        return self.Transformer(fused, mask, embed_is_mlp=True, **kw)


class B1LSTM(_Family):
    """variant "default": the B1 Highway (ReLU on the projection) and the
    MultiLSTM at embed 512, embed and decoder dropout 0.4; "legacy": the
    plain Highway, embed 128, embed dropout 0.1 and no decoder dropout."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator | None = None):
        super().__init__(cfg, gen)
        legacy = cfg.variant == "legacy"
        self.relu_proj = not legacy
        self.dropouts = (0.1, 0.0) if legacy else (0.4, 0.4)
        self.LSTM = MultiLSTM(cfg.total_embed_size,
                              embed_dim=128 if legacy else 512, h_dim=256,
                              gen=gen)

    def dropout_sites(self) -> DropoutSites:
        return self._sites(
            embed=True, decoder=True, embed_width=self.cfg.total_embed_size,
            decoder_width=self.LSTM.decoder_fc1.out_features)

    def forward(self, inputs, mask, *, mask_mode: str | None = None,
                seeds=None, plain: bool = False,
                encoder_backward: str = "perlayer"):
        outs = self.front(inputs, seeds, plain)
        return self.LSTM(self.fused(outs), mask,
                         mask_mode=mask_mode or self.cfg.mask_mode,
                         seeds=seeds, embed_dropout=self.dropouts[0],
                         decoder_dropout=self.dropouts[1])


class B2Trans(_Family):
    def __init__(self, cfg: ModelConfig, gen: torch.Generator | None = None):
        super().__init__(cfg, gen)
        self.Transformer = UniFullTransformer(cfg.total_embed_size, gen=gen)

    def forward(self, inputs, mask, *, mask_mode: str | None = None,
                seeds=None, plain: bool = False,
                encoder_backward: str = "perlayer"):
        outs = self.front(inputs, seeds, plain)
        return self.Transformer(self.fused(outs), mask,
                                mask_mode=mask_mode or self.cfg.mask_mode,
                                plain=plain, seeds=seeds,
                                encoder_backward=encoder_backward)


class B3MFN(_Family):
    """B3's MFN takes the head's seeds itself (the JAX apply passes it
    r_head, where the MFT passes the last key of a split)."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator | None = None):
        super().__init__(cfg, gen)
        self.Transformer = (MFTHead(cfg, gen, with_encoders=False)
                            if len(cfg.modalities) > 1
                            else UniTransformer(cfg.total_embed_size, gen=gen))

    def dropout_sites(self) -> DropoutSites:
        if len(self.cfg.modalities) == 1:
            return super().dropout_sites()
        return self._sites(**_mfn_sites(self.Transformer))

    def forward(self, inputs, mask, *, mask_mode: str | None = None,
                seeds=None, plain: bool = False,
                encoder_backward: str = "perlayer"):
        mods = self.cfg.modalities
        outs = self.front(inputs, seeds, plain)
        head = self.Transformer
        if len(mods) == 1:
            return head(outs[mods[0]], mask,
                        mask_mode=mask_mode or self.cfg.mask_mode, plain=plain,
                        seeds=seeds, encoder_backward=encoder_backward)
        mfn_in = {m: getattr(head, f"embed_{m}")(outs[m]) for m in mods}
        return _mfn_pred(head, mfn_in, mask, seeds, plain)


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
