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
training forward, with dropout at every site of the family's JAX apply
(hash seeds, or threefry keys for the "threefry" stream); `dropout_sites()`
lists those sites and `dropout_keys(key, T)` splits a step's key along the
JAX apply's key tree into theirs, so that a trainer derives the seeds of
exactly them (`DropoutSeeds.from_key`).  encoder_backward picks the encoders' training
backward on the card: "perlayer" (kernel 4 per layer) or "stack" (kernel
5).  `build_model(cfg, seed=s)` draws the weights of the JAX package's
`<family>_init(PRNGKey(s))`, the same numbers, on the given device.

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

from ..ops.attention import Encoder, encoder_init
from ..ops.mfn_core import MFN, mfn_init, mfn_scan
from ..ops.seeds import DropoutSeeds, DropoutSites, encoder_keys, mfn_keys
from ..utils import prng
from ..utils.init import linear_init
from ..utils.params import load_jax_params
from .config import FAMILIES, MFT_EMBED_DIM, ModelConfig, default_config
from .frontend import add_frontend, frontend_apply, frontend_init
from .heads import (HEADS, MultiLSTM, UniFullTransformer, UniTransformer,
                    encode, multi_lstm_init, uni_full_transformer_init,
                    uni_transformer_init)

ENCODER_FF, ENCODER_LAYERS = 128, 6
SFT_FUSE_EMBED = 512


class _Family(nn.Module):
    """The per-modality CNN + Highway front end shared by every family."""

    relu_proj = False

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        add_frontend(self, cfg.modalities, cfg.mod_dimension,
                     cfg.window_embed_size)

    def front(self, inputs, seeds, plain: bool) -> dict:
        return frontend_apply(self, inputs, self.cfg.modalities,
                              None if seeds is None else seeds.front,
                              relu_proj=self.relu_proj, plain=plain)

    def dropout_sites(self) -> DropoutSites:
        """The head's sites: the UniTransformer's encoder, as every
        single-modality head and the SFT's have."""
        return self._sites(encoders=("encoder",))

    def head(self) -> nn.Module:
        return self.Transformer

    def dropout_keys(self, key, T: int) -> DropoutSeeds:
        """The keys of dropout_sites() from a step's key, as the JAX apply
        splits it: the front ends' from its first half, the head's from its
        second (the head's `dropout_keys`)."""
        mods = self.cfg.modalities
        r_front, r_head = prng.split(key)
        head = self.head().dropout_keys(r_head, T)
        if not self.dropout_sites().embed:
            head.pop("embed", None)
        return DropoutSeeds(dict(zip(mods, prng.split(r_front, len(mods)))),
                            **head)

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
            encoder_dims=tuple(dims), split_keys=self.dropout_keys, **kw)

    def fused(self, outs) -> torch.Tensor:
        return torch.cat([outs[m] for m in self.cfg.modalities], dim=-1)


class MFTHead(nn.Module):
    """Per modality Linear embed (+ encoder when with_encoders) and the MFN."""

    def __init__(self, cfg: ModelConfig, with_encoders: bool = True):
        super().__init__()
        self.with_encoders = with_encoders
        for m in cfg.modalities:
            setattr(self, f"embed_{m}", nn.Linear(cfg.window_embed_size[m],
                                                  MFT_EMBED_DIM[m]))
            if with_encoders:
                setattr(self, f"transformer_{m}",
                        Encoder(MFT_EMBED_DIM[m], ENCODER_FF, ENCODER_LAYERS))
        self.mfn = MFN(cfg.modalities, MFT_EMBED_DIM, output_dim=1)

    def dropout_keys(self, key, T: int) -> dict:
        """The MFT's split of the head's key: an encoder a modality, then
        the MFN; B3-MFN's MFN takes the head's key itself."""
        if not self.with_encoders:
            return dict(zip(("mfn", "out"), mfn_keys(key, T)))
        names = [f"transformer_{m}" for m in self.mfn.mods]
        keys = prng.split(key, len(names) + 1)
        tables = encoder_keys(keys[:-1], ENCODER_LAYERS)  # all at once
        return dict(zip(("mfn", "out"), mfn_keys(keys[-1], T)),
                    encoder=dict(zip(names, tables)))


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

    def __init__(self, cfg: ModelConfig):
        super().__init__(cfg)
        self.Transformer = (MFTHead(cfg) if len(cfg.modalities) > 1
                            else UniTransformer(cfg.total_embed_size))

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
                               mask_mode, plain, seeds, name,
                               encoder_backward)
        return _mfn_pred(head, mfn_in, mask, seeds, plain)


class SFT(_Family):
    def __init__(self, cfg: ModelConfig):
        super().__init__(cfg)
        # with one modality the reference still creates the fusion layer
        self.fusionLayer = nn.Linear(cfg.total_embed_size, SFT_FUSE_EMBED)
        self.Transformer = UniTransformer(
            SFT_FUSE_EMBED if len(cfg.modalities) > 1
            else cfg.total_embed_size)

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

    def __init__(self, cfg: ModelConfig):
        super().__init__(cfg)
        legacy = cfg.variant == "legacy"
        self.relu_proj = not legacy
        self.dropouts = (0.1, 0.0) if legacy else (0.4, 0.4)
        self.LSTM = MultiLSTM(cfg.total_embed_size,
                              embed_dim=128 if legacy else 512, h_dim=256)

    def head(self) -> nn.Module:
        return self.LSTM

    def dropout_sites(self) -> DropoutSites:
        return self._sites(
            embed=True, decoder=True,
            embed_width=self.cfg.total_embed_size,
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
    def __init__(self, cfg: ModelConfig):
        super().__init__(cfg)
        self.Transformer = UniFullTransformer(cfg.total_embed_size)

    def dropout_sites(self) -> DropoutSites:
        return self._sites(encoders=("encoder",))

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

    def __init__(self, cfg: ModelConfig):
        super().__init__(cfg)
        self.Transformer = (MFTHead(cfg, with_encoders=False)
                            if len(cfg.modalities) > 1
                            else UniTransformer(cfg.total_embed_size))

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


# ------------------------------------------- the JAX package's key trees


def _frontend(key, cfg: ModelConfig, device) -> dict:
    return frontend_init(key, cfg.modalities, cfg.mod_dimension,
                         cfg.window_embed_size, device=device)


def _mfn_head_init(key, cfg: ModelConfig, with_encoders: bool,
                   device) -> dict:
    """The multi-modality MFT head (embed + encoder a modality, then the
    MFN: split(key, 2M + 1)) or B3-MFN's (embed a modality, then the MFN:
    split(key, M + 1))."""
    mods = cfg.modalities
    per = 2 if with_encoders else 1
    keys = prng.split(key, per * len(mods) + 1)
    head = {}
    for i, m in enumerate(mods):
        head[f"embed_{m}"] = linear_init(keys[per * i],
                                         cfg.window_embed_size[m],
                                         MFT_EMBED_DIM[m], device)
        if with_encoders:
            head[f"transformer_{m}"] = encoder_init(
                keys[per * i + 1], MFT_EMBED_DIM[m], ENCODER_FF,
                ENCODER_LAYERS, device)
    head["mfn"] = mfn_init(keys[-1], mods, MFT_EMBED_DIM, 1, device)
    return head


def mft_init(key, cfg: ModelConfig, device="cpu") -> dict:
    k_front, k_head = prng.split(key)
    params = _frontend(k_front, cfg, device)
    params["Transformer"] = (
        _mfn_head_init(k_head, cfg, True, device) if len(cfg.modalities) > 1
        else uni_transformer_init(k_head, cfg.total_embed_size,
                                  device=device))
    return params


def sft_init(key, cfg: ModelConfig, device="cpu") -> dict:
    k_front, k_fuse, k_head = prng.split(key, 3)
    params = _frontend(k_front, cfg, device)
    params["fusionLayer"] = linear_init(k_fuse, cfg.total_embed_size,
                                        SFT_FUSE_EMBED, device)
    params["Transformer"] = uni_transformer_init(
        k_head, SFT_FUSE_EMBED if len(cfg.modalities) > 1
        else cfg.total_embed_size, device=device)
    return params


def b1_lstm_init(key, cfg: ModelConfig, device="cpu") -> dict:
    k_front, k_head = prng.split(key)
    params = _frontend(k_front, cfg, device)
    embed_dim = 128 if cfg.variant == "legacy" else 512
    params["LSTM"] = multi_lstm_init(k_head, cfg.total_embed_size,
                                     embed_dim=embed_dim, h_dim=256,
                                     device=device)
    return params


def b2_trans_init(key, cfg: ModelConfig, device="cpu") -> dict:
    k_front, k_head = prng.split(key)
    params = _frontend(k_front, cfg, device)
    params["Transformer"] = uni_full_transformer_init(
        k_head, cfg.total_embed_size, device=device)
    return params


def b3_mfn_init(key, cfg: ModelConfig, device="cpu") -> dict:
    k_front, k_head = prng.split(key)
    params = _frontend(k_front, cfg, device)
    params["Transformer"] = (
        _mfn_head_init(k_head, cfg, False, device) if len(cfg.modalities) > 1
        else uni_transformer_init(k_head, cfg.total_embed_size,
                                  device=device))
    return params


FAMILY_INITS = {"MFT": mft_init, "SFT": sft_init, "B1-LSTM": b1_lstm_init,
                "B2-Trans": b2_trans_init, "B3-MFN": b3_mfn_init}


def build_model(cfg: ModelConfig, *, seed: int | None = None,
                device: torch.device | str = "cpu",
                prng_impl: str = "threefry") -> nn.Module:
    """The family's module on `device`, the CPU unless the caller names
    another, as a module's constructor is (the Engine, the CLI, serving
    and the benches pass the card).  With a seed, its weights are the JAX
    package's `<family>_init(PRNGKey(seed))` under the key implementation
    `prng_impl` ("threefry", JAX's default, or "rbg"), drawn on that device
    (kernel T, or kernel P for rbg keys, on the card; their plain versions
    on the CPU); without one, PyTorch's default init, for a module whose
    weights are loaded next."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}; expected one of "
                         f"{FAMILIES}")
    cls = FAMILY_MODULES[cfg.family]
    if seed is None:
        with torch.device(device):
            return cls(cfg)
    with torch.device("meta"):  # every tensor is drawn below
        module = cls(cfg)
    module = module.to_empty(device=device)
    tree = FAMILY_INITS[cfg.family](prng.key(seed, prng_impl), cfg, device)
    return load_jax_params(module, tree)


def legacy_ar_smoke(module: nn.Module, data_dir: str, subset: str,
                    device: torch.device | str = "cuda"):
    """The body of the smoke run below, on a given `MultiARLSTM` (108 input
    features): B3-MFN's acoustic + emotient windows of `subset` read and
    windowed, the first frame of each window of the first video passed
    through the module in eval mode, its valences printed as the JAX
    package's smoke prints them.  Returns them, [W] float32."""
    from ..data import load_send, window_pipeline

    print("Loading data...")
    cfg = default_config("B3-MFN", ("acoustic", "emotient"))
    dataset = load_send(list(cfg.modalities), data_dir, subset)
    padded, _, _ = window_pipeline(dataset, cfg.window_size, cfg.modalities,
                                   cfg.mod_dimension)
    print("Passing a sample through the model...")
    device = torch.device(device)
    x = torch.cat([torch.from_numpy(padded[m][:1, :, 0, :])
                   for m in cfg.modalities], dim=2).to(device)
    mask = torch.ones(1, x.shape[1], 1, device=device)
    module = module.to(device).eval()
    with torch.no_grad():
        out = module(x, mask).reshape(-1).cpu().numpy()
    print("Predicted valences:")
    for o in out:
        print("{:+0.3f}".format(float(o)))
    return out


if __name__ == "__main__":
    # The smoke run of the JAX package's models/families.py (the analog of
    # the reference's `python models.py --dir --subset`, MFT/models.py:
    # 402-428): a MultiARLSTM on windowed SENDv1, on the card unless
    # --device cpu, with the JAX run's weights (PRNGKey(0)).
    import argparse
    import sys

    from .legacy_lstm import MultiARLSTM, multi_ar_lstm_init

    parser = argparse.ArgumentParser()
    parser.add_argument('--dir', type=str, default="../data")
    parser.add_argument('--subset', type=str, default="Train")
    parser.add_argument('--device', type=str, default="cuda")
    args = parser.parse_args()
    if (torch.device(args.device).type == "cuda"
            and not torch.cuda.is_available()):
        sys.exit(f"error: --device {args.device}: no CUDA device is "
                 "available (pass --device cpu to run on the CPU)")
    print("Building model...")
    cfg = default_config("B3-MFN", ("acoustic", "emotient"))
    total = sum(cfg.mod_dimension[m] for m in cfg.modalities)
    with torch.device(args.device):
        module = MultiARLSTM(total)
    legacy_ar_smoke(load_jax_params(module, multi_ar_lstm_init(
        prng.key(0), total, device=args.device)), args.dir, args.subset,
        args.device)
