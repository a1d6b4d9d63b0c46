"""The legacy LSTM heads of the reference inventory, in eval and training.

Counterparts of `multimodal_transformer_tpu/models/legacy_lstm.py`
(reference MFT/models.py:222-400).  No family builds them; the smoke run of
`models/families.py` (`python -m multimodal_transformer_tpu_torch.models.
families`) drives `MultiARLSTM`, as the reference's `python models.py` does.

  * `MultiEDLSTM`: embed -> time-softmax local attention -> encoder LSTM
    (embed -> h) from learned `enc_h0`/`enc_c0` -> attention convolution ->
    a stepwise decoder LSTM over [p_prev; context_t] from learned
    `dec_h0`/`dec_c0` -> MLP -> valence.  The decoder's input projection of
    the context is hoisted out of the loop; p_prev enters through the
    first column of its `weight_ih`.
  * `MultiARLSTM`: embed -> attention -> LSTM -> attention convolution ->
    a per-step input part (MLP) and `ar_order` AR weights.  With a target
    it teacher-forces over the shifted targets; without one it runs the AR
    recurrence on its own detached predictions (the JAX package's
    `stop_gradient`).

Parameter names are the JAX trees' (`embed`, `attn_fc1`, `attn_fc2`,
`encoder`, `enc_h0`, ..., `autoreg`), so `utils.params.load_jax_params`
carries a JAX tree across key for key; `multi_ed_lstm_init` and
`multi_ar_lstm_init` draw that tree along the JAX key tree, the same
numbers for the same key.  The one dropout site is the embed
dropout on the input x [B, T, window_embed] (`seeds.embed`, the hash
dropout of ops/basic.py).  Both heads are plain PyTorch: the JAX package
has no kernel for them.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.basic import dropout
from ..ops.recurrent import (convolve_local_attn, lstm_cell_update, lstm_scan,
                             pad_shift)
from ..ops.seeds import DropoutSeeds, DropoutSites
from ..utils import prng
from ..utils.init import linear_init, lstm_init
from .heads import time_softmax_attn_weights

EMBED_DROPOUT = 0.1


def _embed_seed(seeds):
    return None if seeds is None else seeds.embed


def _initial(state: nn.Parameter, B: int, like: torch.Tensor) -> torch.Tensor:
    """A learned [1, H] initial state broadcast to the batch."""
    return state.to(like.dtype).expand(B, state.shape[1])


def _legacy_keys(key, T: int) -> DropoutSeeds:
    """A legacy head's split of its key: 1, the embed's (no front end)."""
    return DropoutSeeds({}, embed=prng.split(key, 1)[0])


class MultiEDLSTM(nn.Module):
    def __init__(self, window_embed_size: int, embed_dim: int = 128,
                 h_dim: int = 512, attn_len: int = 3):
        super().__init__()
        self.window_embed_size = window_embed_size
        self.embed = nn.Linear(window_embed_size, embed_dim)
        self.attn_fc1 = nn.Linear(embed_dim, embed_dim)
        self.attn_fc2 = nn.Linear(embed_dim, attn_len)
        self.encoder = nn.LSTMCell(embed_dim, h_dim)
        self.enc_h0 = nn.Parameter(torch.zeros(1, h_dim))
        self.enc_c0 = nn.Parameter(torch.zeros(1, h_dim))
        self.decoder = nn.LSTMCell(1 + h_dim, h_dim)
        self.dec_h0 = nn.Parameter(torch.zeros(1, h_dim))
        self.dec_c0 = nn.Parameter(torch.zeros(1, h_dim))
        self.out_fc1 = nn.Linear(h_dim, embed_dim)
        self.out_fc2 = nn.Linear(embed_dim, 1)

    def dropout_sites(self) -> DropoutSites:
        return DropoutSites(front=(), embed=True,
                            embed_width=self.window_embed_size,
                            split_keys=self.dropout_keys)

    dropout_keys = staticmethod(_legacy_keys)

    def forward(self, x, mask, *, seeds=None, tgt_init: float = 0.0,
                embed_dropout: float = EMBED_DROPOUT) -> torch.Tensor:
        """x [B, T, window_embed], mask [B, T, 1] -> [B, T, 1]; seeds: the
        step's DropoutSeeds in training, None in eval."""
        B, T, _ = x.shape
        e = dropout(x, _embed_seed(seeds), embed_dropout)
        e = torch.relu(self.embed(e))
        attn = time_softmax_attn_weights(self, e)
        enc_out, _ = lstm_scan(self.encoder, e, _initial(self.enc_h0, B, x),
                               _initial(self.enc_c0, B, x))
        context = convolve_local_attn(enc_out, attn)  # [B, T, h]

        dec = self.decoder
        w_p, w_ctx = dec.weight_ih[:, :1], dec.weight_ih[:, 1:]
        ctx_proj = context @ w_ctx.T + dec.bias_ih + dec.bias_hh  # [B, T, 4H]
        w_p_t, w_hh_t = w_p.T, dec.weight_hh.T
        h = _initial(self.dec_h0, B, x)
        c = _initial(self.dec_c0, B, x)
        p = torch.full((B, 1), tgt_init, dtype=x.dtype, device=x.device)
        preds = []
        for t in range(T):
            h, c = lstm_cell_update(ctx_proj[:, t] + p @ w_p_t + h @ w_hh_t,
                                    c)
            p = self.out_fc2(torch.relu(self.out_fc1(h)))
            preds.append(p)
        return torch.stack(preds, dim=1) * mask


def multi_ed_lstm_init(key, window_embed_size: int, embed_dim: int = 128,
                       h_dim: int = 512, attn_len: int = 3,
                       device="cpu") -> dict:
    k_e, k_a1, k_a2, k_enc, k_dec, k_o1, k_o2 = prng.split(key, 7)
    return {"embed": linear_init(k_e, window_embed_size, embed_dim, device),
            "attn_fc1": linear_init(k_a1, embed_dim, embed_dim, device),
            "attn_fc2": linear_init(k_a2, embed_dim, attn_len, device),
            "encoder": lstm_init(k_enc, embed_dim, h_dim, device),
            "enc_h0": torch.zeros(1, h_dim, device=device),
            "enc_c0": torch.zeros(1, h_dim, device=device),
            "decoder": lstm_init(k_dec, 1 + h_dim, h_dim, device),
            "dec_h0": torch.zeros(1, h_dim, device=device),
            "dec_c0": torch.zeros(1, h_dim, device=device),
            "out_fc1": linear_init(k_o1, h_dim, embed_dim, device),
            "out_fc2": linear_init(k_o2, embed_dim, 1, device)}


class MultiARLSTM(nn.Module):
    def __init__(self, window_embed_size: int, embed_dim: int = 128,
                 h_dim: int = 512, attn_len: int = 7, ar_order: int = 1):
        super().__init__()
        self.window_embed_size = window_embed_size
        self.ar_order = ar_order
        self.embed = nn.Linear(window_embed_size, embed_dim)
        self.attn_fc1 = nn.Linear(embed_dim, embed_dim)
        self.attn_fc2 = nn.Linear(embed_dim, attn_len)
        self.lstm = nn.LSTMCell(embed_dim, h_dim)
        self.decoder_fc1 = nn.Linear(h_dim, embed_dim)
        self.decoder_fc2 = nn.Linear(embed_dim, 1)
        self.autoreg = nn.Linear(h_dim, ar_order)

    def dropout_sites(self) -> DropoutSites:
        return DropoutSites(front=(), embed=True,
                            embed_width=self.window_embed_size,
                            split_keys=self.dropout_keys)

    dropout_keys = staticmethod(_legacy_keys)

    def forward(self, x, mask, *, seeds=None, target=None,
                tgt_init: float = 0.0,
                embed_dropout: float = EMBED_DROPOUT) -> torch.Tensor:
        """x [B, T, window_embed], mask [B, T, 1] -> [B, T, 1]; a target
        [B, T, 1] turns on teacher forcing; seeds as in MultiEDLSTM."""
        B, T, _ = x.shape
        e = dropout(x, _embed_seed(seeds), embed_dropout)
        e = torch.relu(self.embed(e))
        attn = time_softmax_attn_weights(self, e)
        h, _ = lstm_scan(self.lstm, e)
        context = convolve_local_attn(h, attn)
        in_part = self.decoder_fc2(torch.relu(self.decoder_fc1(context)))
        ar_weight = self.autoreg(context)  # [B, T, ar_order]

        if target is not None:
            ar_stacked = torch.stack([pad_shift(target, i)
                                      for i in range(self.ar_order)], dim=-1)
            ar_part = (ar_weight[:, :, None, :] * ar_stacked).sum(dim=-1)
            return (in_part + ar_part) * mask
        # the last ar_order predictions, most recent last, detached
        hist = torch.full((B, self.ar_order), tgt_init, dtype=x.dtype,
                          device=x.device)
        preds = []
        for t in range(T):
            p = in_part[:, t] + (ar_weight[:, t] * hist.detach()).sum(
                dim=1, keepdim=True)
            hist = torch.cat([hist[:, 1:], p], dim=1)
            preds.append(p)
        return torch.stack(preds, dim=1) * mask


def multi_ar_lstm_init(key, window_embed_size: int, embed_dim: int = 128,
                       h_dim: int = 512, attn_len: int = 7,
                       ar_order: int = 1, device="cpu") -> dict:
    k_e, k_a1, k_a2, k_l, k_d1, k_d2, k_ar = prng.split(key, 7)
    return {"embed": linear_init(k_e, window_embed_size, embed_dim, device),
            "attn_fc1": linear_init(k_a1, embed_dim, embed_dim, device),
            "attn_fc2": linear_init(k_a2, embed_dim, attn_len, device),
            "lstm": lstm_init(k_l, embed_dim, h_dim, device),
            "decoder_fc1": linear_init(k_d1, h_dim, embed_dim, device),
            "decoder_fc2": linear_init(k_d2, embed_dim, 1, device),
            "autoreg": linear_init(k_ar, h_dim, ar_order, device)}
