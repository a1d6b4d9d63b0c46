"""Output heads of the families other than the multi-modality MFT.

Counterparts of `multimodal_transformer_tpu/models/heads.py`, in eval mode and
in training (with `seeds`, ops/seeds.py):

  * `UniTransformer`: Linear embed (or, as the NLPTransformer of the SFT,
    Dropout -> Linear -> ReLU) -> encoder -> stepwise LSTM decoder over
    [o_prev; enc_t] -> MLP; used by SFT, and by MFT and B3-MFN with one
    modality;
  * `UniFullTransformer`: Linear embed -> encoder -> per-step MLP (B2-Trans);
  * `MultiLSTM`: Linear+ReLU embed -> local attention whose softmax runs
    over the TIME axis -> LSTM -> causal attention convolution -> MLP
    (B1-LSTM).

Parameter names follow the JAX trees: `embed`, `encoder`, `decoder`,
`dec_h0`, `dec_c0`, `out_fc1`, `out_fc2`; `embed`, `attn_fc1`, `attn_fc2`,
`lstm`, `decoder_fc1`, `decoder_fc2`; each head's `*_init` draws them
along the JAX package's key tree.  The encoders dispatch as
`ops.attention.encoder_stack` does (plain=True takes the plain encoder on
any device; `encoder_backward` picks the training backward on the card);
the LSTM recurrences are plain PyTorch with autograd, as in the JAX package.

Dropout sites in training (the JAX package's rates): the encoder's four per
layer at 0.1 (`seeds.encoder["encoder"]`); the NLPTransformer's input
dropout at 0.1 on the [B, T, 512] fused input (`seeds.embed`); the
MultiLSTM's embed and decoder dropout, at rates its family gives
(`seeds.embed`, `seeds.decoder`).
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.attention import (Encoder, encoder_init, encoder_stack,
                             encoder_stack_plain)
from ..ops.basic import dropout
from ..ops.recurrent import convolve_local_attn, lstm_cell_update, lstm_scan
from ..ops.seeds import encoder_keys
from ..utils import prng
from ..utils.init import linear_init, lstm_init

HEADS = 8
NEG_INF = -1e9
EMBED_DROPOUT = 0.1   # the NLPTransformer's input dropout (heads.py:91-93)


def _site(seeds, name: str):
    return None if seeds is None else getattr(seeds, name)


def encode(enc: Encoder, e, mask, mask_mode: str, plain: bool, seeds=None,
           name: str = "encoder", encoder_backward: str = "perlayer"):
    """An encoder of a family, h = 8 heads: the plain encoder when plain,
    else as `encoder_stack` routes it; seeds: the step's `DropoutSeeds`
    (the encoder's [N, 4] table is `seeds.encoder[name]`, on the stream
    `seeds.hash4`) in training, None in eval."""
    table = None if seeds is None else seeds.encoder[name]
    hash4 = seeds is not None and seeds.hash4
    if plain:
        return encoder_stack_plain(enc, e, mask, h=HEADS, mask_mode=mask_mode,
                                   seeds=table, hash4=hash4)
    return encoder_stack(enc, e, mask, h=HEADS, mask_mode=mask_mode,
                         seeds=table, backward=encoder_backward, hash4=hash4)


def _encode(head: nn.Module, e, mask, mask_mode: str, plain: bool, seeds,
            encoder_backward: str):
    """The head's own encoder, whose seeds are `seeds.encoder["encoder"]`."""
    return encode(head.encoder, e, mask, mask_mode, plain, seeds, "encoder",
                  encoder_backward)


def _mlp_out(head: nn.Module, x: torch.Tensor) -> torch.Tensor:
    return head.out_fc2(torch.relu(head.out_fc1(x)))


class UniTransformer(nn.Module):
    def __init__(self, window_embed_size: int, embed_dim: int = 256,
                 h_dim: int = 128, n_enc: int = 6, d_ff: int = 128):
        super().__init__()
        self.embed = nn.Linear(window_embed_size, embed_dim)
        self.encoder = Encoder(embed_dim, d_ff, n_enc)
        self.decoder = nn.LSTMCell(2 * embed_dim, embed_dim)
        self.dec_h0 = nn.Parameter(torch.zeros(1, embed_dim))
        self.dec_c0 = nn.Parameter(torch.zeros(1, embed_dim))
        self.out_fc1 = nn.Linear(embed_dim, h_dim)
        self.out_fc2 = nn.Linear(h_dim, 1)

    def dropout_keys(self, key, T: int) -> dict:
        """The JAX apply's split of the head's key: 3, the MLP embed's [0]
        and the encoder's [1]."""
        keys = prng.split(key, 3)
        return {"embed": keys[0], "encoder": {
            "encoder": encoder_keys(keys[1], len(self.encoder.layers))}}

    def forward(self, x, mask, *, mask_mode: str, plain: bool = False,
                embed_is_mlp: bool = False, seeds=None,
                encoder_backward: str = "perlayer") -> torch.Tensor:
        """x [B, T, window_embed]; mask [B, T, 1].  Returns [B, T, 1].
        embed_is_mlp: the NLPTransformer embed, Dropout -> Linear -> ReLU;
        seeds: the step's DropoutSeeds in training, None in eval."""
        if embed_is_mlp:
            x = dropout(x, _site(seeds, "embed"), EMBED_DROPOUT)
            e = torch.relu(self.embed(x))
        else:
            e = self.embed(x)
        enc = _encode(self, e, mask, mask_mode, plain, seeds, encoder_backward)
        return _mlp_out(self, lstm_decoder_scan(self, enc)) * mask


def uni_transformer_init(key, window_embed_size: int, embed_dim: int = 256,
                         h_dim: int = 128, n_enc: int = 6, d_ff: int = 128,
                         device="cpu") -> dict:
    k_embed, k_enc, k_dec, k_o1, k_o2 = prng.split(key, 5)
    return {"embed": linear_init(k_embed, window_embed_size, embed_dim,
                                 device),
            "encoder": encoder_init(k_enc, embed_dim, d_ff, n_enc, device),
            "decoder": lstm_init(k_dec, 2 * embed_dim, embed_dim, device),
            "dec_h0": torch.zeros(1, embed_dim, device=device),
            "dec_c0": torch.zeros(1, embed_dim, device=device),
            "out_fc1": linear_init(k_o1, embed_dim, h_dim, device),
            "out_fc2": linear_init(k_o2, h_dim, 1, device)}


def lstm_decoder_scan(head: UniTransformer, enc: torch.Tensor) -> torch.Tensor:
    """The stepwise decoder: i_t = [o_prev; enc_t] -> LSTMCell -> o_t (the new
    hidden state), from (dec_h0, dec_c0) and o_prev = 0.  The enc_t half of
    the input projection is hoisted out of the loop.  enc [B, T, D]; returns
    [B, T, D]."""
    B, T, D = enc.shape
    cell = head.decoder
    w_prev, w_enc = cell.weight_ih[:, :D], cell.weight_ih[:, D:]
    enc_proj = enc @ w_enc.T + cell.bias_ih + cell.bias_hh  # [B, T, 4H]
    w_prev_t, w_hh_t = w_prev.T, cell.weight_hh.T
    h = head.dec_h0.expand(B, D).to(enc.dtype)
    c = head.dec_c0.expand(B, D).to(enc.dtype)
    o = torch.zeros(B, D, dtype=enc.dtype, device=enc.device)
    outs = []
    for t in range(T):
        h, c = lstm_cell_update(enc_proj[:, t] + o @ w_prev_t + h @ w_hh_t, c)
        o = h
        outs.append(h)
    return torch.stack(outs, dim=1)


class UniFullTransformer(nn.Module):
    def __init__(self, window_embed_size: int, embed_dim: int = 256,
                 h_dim: int = 128, n_enc: int = 6, d_ff: int = 128):
        super().__init__()
        self.embed = nn.Linear(window_embed_size, embed_dim)
        self.encoder = Encoder(embed_dim, d_ff, n_enc)
        self.out_fc1 = nn.Linear(embed_dim, h_dim)
        self.out_fc2 = nn.Linear(h_dim, 1)

    def dropout_keys(self, key, T: int) -> dict:
        """The JAX apply's split of the head's key: 1, the encoder's."""
        return {"encoder": {"encoder": encoder_keys(
            prng.split(key, 1)[0], len(self.encoder.layers))}}

    def forward(self, x, mask, *, mask_mode: str, plain: bool = False,
                seeds=None, encoder_backward: str = "perlayer") -> torch.Tensor:
        enc = _encode(self, self.embed(x), mask, mask_mode, plain, seeds,
                      encoder_backward)
        return _mlp_out(self, enc) * mask


def uni_full_transformer_init(key, window_embed_size: int,
                              embed_dim: int = 256, h_dim: int = 128,
                              n_enc: int = 6, d_ff: int = 128,
                              device="cpu") -> dict:
    k_embed, k_enc, k_o1, k_o2 = prng.split(key, 4)
    return {"embed": linear_init(k_embed, window_embed_size, embed_dim,
                                 device),
            "encoder": encoder_init(k_enc, embed_dim, d_ff, n_enc, device),
            "out_fc1": linear_init(k_o1, embed_dim, h_dim, device),
            "out_fc2": linear_init(k_o2, h_dim, 1, device)}


def time_softmax_attn_weights(head: "MultiLSTM", e: torch.Tensor,
                              mask=None) -> torch.Tensor:
    """The B1 local-attention weights: Linear -> ReLU -> Linear -> softmax
    over the TIME axis (the reference's Softmax(dim=1) on [B, T, attn_len],
    a quirk kept as it is).  With a [B, T, 1] mask, padded steps' logits are
    -1e9, so the weights do not depend on the padding; mask=None is the
    reference's unmasked softmax."""
    logits = head.attn_fc2(torch.relu(head.attn_fc1(e)))  # [B, T, K]
    if mask is not None:
        logits = logits.masked_fill(mask == 0, NEG_INF)
    return torch.softmax(logits, dim=1)


class MultiLSTM(nn.Module):
    def __init__(self, window_embed_size: int, embed_dim: int = 512,
                 h_dim: int = 256, attn_len: int = 5):
        super().__init__()
        self.embed = nn.Linear(window_embed_size, embed_dim)
        self.attn_fc1 = nn.Linear(embed_dim, embed_dim)
        self.attn_fc2 = nn.Linear(embed_dim, attn_len)
        self.lstm = nn.LSTMCell(embed_dim, h_dim)
        self.decoder_fc1 = nn.Linear(h_dim, embed_dim)
        self.decoder_fc2 = nn.Linear(embed_dim, 1)

    def dropout_keys(self, key, T: int) -> dict:
        """The JAX apply's split of the head's key: 2, the embed's and the
        decoder's."""
        embed, decoder = prng.split(key)
        return {"embed": embed, "decoder": decoder}

    def forward(self, x, mask, *, mask_mode: str, seeds=None,
                embed_dropout: float = 0.4,
                decoder_dropout: float = 0.4) -> torch.Tensor:
        """mask_mode "query" keeps the reference's unmasked time softmax;
        "key_query" masks padded steps out of it.  seeds: the step's
        DropoutSeeds in training (dropout on x [B, T, window_embed] and on
        the decoder's [B, T, embed] hidden at the given rates), None in
        eval.  Returns [B, T, 1]."""
        x = dropout(x, _site(seeds, "embed"), embed_dropout)
        e = torch.relu(self.embed(x))
        a = time_softmax_attn_weights(
            self, e, mask if mask_mode == "key_query" else None)
        h, _ = lstm_scan(self.lstm, e)
        d = torch.relu(self.decoder_fc1(convolve_local_attn(h, a)))
        d = dropout(d, _site(seeds, "decoder"), decoder_dropout)
        return self.decoder_fc2(d) * mask


def multi_lstm_init(key, window_embed_size: int, embed_dim: int = 512,
                    h_dim: int = 256, attn_len: int = 5,
                    device="cpu") -> dict:
    k_e, k_a1, k_a2, k_l, k_d1, k_d2 = prng.split(key, 6)
    return {"embed": linear_init(k_e, window_embed_size, embed_dim, device),
            "attn_fc1": linear_init(k_a1, embed_dim, embed_dim, device),
            "attn_fc2": linear_init(k_a2, embed_dim, attn_len, device),
            "lstm": lstm_init(k_l, embed_dim, h_dim, device),
            "decoder_fc1": linear_init(k_d1, h_dim, embed_dim, device),
            "decoder_fc2": linear_init(k_d2, embed_dim, 1, device)}
