"""Multi-head attention and the pre-norm encoder stack.

Counterpart of `multimodal_transformer_tpu/ops/attention.py`.  Training
mode takes the stack's [N, 4] dropout seed table (one seed per layer for
each of the four sites: attention probabilities, attention output, FFN
hidden, FFN output) and applies the dropout of ops/basic.py; without seeds
the stack runs in eval mode.  A table of threefry keys ([N, 4, 2], the
"threefry" dropout, [N, 4, 4] under rbg keys; on a data-parallel rank
`prng.RowKeys`, whose draws are the global batch's at the rank's rows)
takes the plain path on any device, with each site's mask drawn by kernel
T (kernel P under rbg keys) on the card, as the JAX package keeps that
stream on its jnp encoder (no kernel regenerates its bits).  A hash
table with `hash4=True` (the "hash4" dropout) takes the hash's routes:
kernels 3, 4 and 5 draw its multi-bit masks, as the JAX package's kernels
do.  `encoder_init` draws the weights along the JAX key tree (one layer
drawn, copied N times, as the reference's `clones()`).  Two mask modes, as
in the JAX package:

  * "query" (the reference's quirk, kept as it is): the [B, T, 1] mask is
    broadcast over the query rows only, so padded query rows get -1e9
    everywhere while valid queries still attend to padded keys;
  * "key_query": padded keys are masked as well, which makes the valid rows
    independent of how much padding a batch carries.

`encoder_stack` dispatches by `dispatch.encoder_route`: a CUDA tensor in
"key_query" mode goes to the fused encoder kernel A (ops/cuda/encoder.py) up
to T = 512, past it layer by layer with attention through kernel 11
(ops/cuda/flash_attention.py; the JAX package's long-T route, its fused
kernel declining and its flash kernel serving each layer), and with seeds
to the training kernels (ops/cuda/encoder_train.py: kernel 3, then kernel 4
per layer or kernel 5 per stack in the backward; its output takes the final
norm here so that autograd owns its parameters) at every T, as does a call
without seeds that needs gradients, at p = 0 with an all-zero seed table
(kernel A has no backward; eval under `torch.no_grad()` or
`torch.inference_mode()` keeps kernel A and the flash route); a CPU
tensor takes the plain path below.  "query" mode (and a stack without a
mask) takes the plain path on any device: that is dispatch by mode, as in
the JAX package, whose encoder kernels take key_query only and which runs
query mode through its jnp encoder on the TPU too (`ops/attention.py`
there); it is not a fallback on failure.  `encoder_stack_plain` launches
nothing on any device.

A tensor-parallel encoder (parallel/tp.py: `tp_group` set, each layer
holding its rank's heads and FFN columns) runs eval only, layer by layer:
its attention through kernel 11 in "key_query" mode and plain in "query"
mode, one `all_reduce` after the out projection and one after w_2, each
before the replicated bias.  Kernel A fuses the layer across those points,
so it cannot serve a sharded layer.
"""

from __future__ import annotations

import copy

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..utils import prng
from ..utils.init import linear_init, norm_init
from .basic import dropout, site_seed
from .dispatch import encoder_route, needs_grad, use_kernel
from .norm import LayerNorm

NEG_INF = -1e9
DROPOUT = 0.1


class MultiHeadAttention(nn.Module):
    def __init__(self, d_model: int):
        super().__init__()
        self.linears = nn.ModuleList(nn.Linear(d_model, d_model)
                                     for _ in range(4))


class FeedForward(nn.Module):
    def __init__(self, d_model: int, d_ff: int):
        super().__init__()
        self.w_1 = nn.Linear(d_model, d_ff)
        self.w_2 = nn.Linear(d_ff, d_model)


class Sublayer(nn.Module):
    def __init__(self, d_model: int):
        super().__init__()
        self.norm = LayerNorm(d_model)


class EncoderLayer(nn.Module):
    def __init__(self, d_model: int, d_ff: int):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model)
        self.feed_forward = FeedForward(d_model, d_ff)
        self.sublayer = nn.ModuleList(Sublayer(d_model) for _ in range(2))


class Encoder(nn.Module):
    """N identical layers (the reference deep-copies one initialised layer)
    plus a final norm.  tp_group / tp_size: the "model" group and its size
    of a tensor-parallel copy (parallel/tp.py), None / 1 otherwise."""

    tp_group = None
    tp_size = 1

    def __init__(self, d_model: int, d_ff: int, n_layers: int):
        super().__init__()
        layer = EncoderLayer(d_model, d_ff)
        self.layers = nn.ModuleList(copy.deepcopy(layer)
                                    for _ in range(n_layers))
        self.norm = LayerNorm(d_model)


def mha_init(key, d_model: int, device="cpu") -> dict:
    return {"linears": [linear_init(k, d_model, d_model, device)
                        for k in prng.split(key, 4)]}


def encoder_layer_init(key, d_model: int, d_ff: int, device="cpu") -> dict:
    k_attn, k_ff1, k_ff2 = prng.split(key, 3)
    return {"self_attn": mha_init(k_attn, d_model, device),
            "feed_forward": {"w_1": linear_init(k_ff1, d_model, d_ff, device),
                             "w_2": linear_init(k_ff2, d_ff, d_model, device)},
            "sublayer": [{"norm": norm_init(d_model, device)}
                         for _ in range(2)]}


def encoder_init(key, d_model: int, d_ff: int, n_layers: int,
                 device="cpu") -> dict:
    """N identical layers (the JAX package's `encoder_init`) + final norm."""
    layer = encoder_layer_init(key, d_model, d_ff, device)
    return {"layers": [layer] * n_layers, "norm": norm_init(d_model, device)}


def attention_heads(attn: MultiHeadAttention, query, key, value, mask=None,
                    *, h: int, mask_mode: str = "query", seed=None,
                    dropout_p: float = DROPOUT, flash: bool = False):
    """The JAX package's multi_head_attention before its out projection.
    query/key/value [B, T, D]; mask [B, T, 1] or None; seed: the dropout
    seed of the [B, h, T, T] probabilities (None in eval).  flash=True (eval
    in "key_query" mode): the attention runs through kernel 11 on the heads
    flattened to [B*h, T, d_k], the JAX package's flash branch.  Returns the
    h heads' outputs concatenated, [B, T, h * d_k] (a tensor-parallel rank's
    q, k, v projections give h * d_k of the model's D columns)."""
    B = query.shape[0]
    D = attn.linears[0].out_features
    d_k = D // h

    def proj(lin, x):
        return lin(x).view(B, -1, h, d_k).transpose(1, 2)

    if flash:
        from .cuda.flash_attention import FlashAttention

        def flat(lin, x):  # a view when B = 1: the kernel takes it packed
            return proj(lin, x).reshape(B * h, -1, d_k).contiguous()

        o = FlashAttention.apply(flat(attn.linears[0], query),
                                 flat(attn.linears[1], key),
                                 flat(attn.linears[2], value), mask[..., 0], h)
        return o.view(B, h, -1, d_k).transpose(1, 2).reshape(B, -1, D)

    q = proj(attn.linears[0], query)     # [B, h, Tq, d_k]
    k = proj(attn.linears[1], key)
    v = proj(attn.linears[2], value)
    scale = torch.tensor(d_k, dtype=query.dtype, device=query.device).sqrt()
    scores = q @ k.transpose(-2, -1) / scale
    if mask is not None:
        qmask = mask[:, None, :, 0:1]                 # [B, 1, Tq, 1]
        scores = scores.masked_fill(qmask == 0, NEG_INF)
        if mask_mode == "key_query":
            kmask = mask[..., 0][:, None, None, :]    # [B, 1, 1, Tk]
            scores = scores.masked_fill(kmask == 0, NEG_INF)
    p = dropout(torch.softmax(scores, dim=-1), seed, dropout_p)
    return (p @ v).transpose(1, 2).reshape(B, -1, D)


def row_parallel(lin: nn.Linear, x, group):
    """lin(x) of a layer whose input axis is split over `group`: each rank's
    partial product summed by one all_reduce, then the bias (None: lin(x))."""
    if group is None:
        return lin(x)
    y = F.linear(x, lin.weight)
    dist.all_reduce(y, group=group)
    return y + lin.bias


def encoder_layer(layer: EncoderLayer, x, mask, *, h: int, mask_mode: str,
                  seeds=None, dropout_p: float = DROPOUT, flash: bool = False,
                  group=None, hash4: bool = False):
    """seeds: the layer's 4 site seeds (or threefry keys), or None in eval;
    hash4: the seeds are the "hash4" stream's;
    flash: attention through kernel 11 (see attention_heads); group: the
    "model" group of a tensor-parallel layer, whose h heads are this
    rank's."""
    s = [None] * 4 if seeds is None else [site_seed(v, hash4) for v in seeds]
    attn, ff = layer.self_attn, layer.feed_forward
    normed = layer.sublayer[0].norm(x)
    heads = attention_heads(attn, normed, normed, normed, mask, h=h,
                            mask_mode=mask_mode, seed=s[0],
                            dropout_p=dropout_p, flash=flash)
    x = x + dropout(row_parallel(attn.linears[3], heads, group), s[1],
                    dropout_p)
    normed = layer.sublayer[1].norm(x)
    mid = dropout(torch.relu(ff.w_1(normed)), s[2], dropout_p)
    return x + dropout(row_parallel(ff.w_2, mid, group), s[3], dropout_p)


def encoder_stack_plain(enc: Encoder, x, mask=None, *, h: int = 8,
                        mask_mode: str = "query", seeds=None,
                        dropout_p: float = DROPOUT, hash4: bool = False):
    """The plain path, on any device.  x: [B, T, D]; seeds: [N, 4] or None;
    hash4: as `encoder_stack`'s."""
    _check_tp(enc, seeds, x)
    for l, layer in enumerate(enc.layers):
        x = encoder_layer(layer, x, mask, h=h // enc.tp_size,
                          mask_mode=mask_mode,
                          seeds=None if seeds is None else seeds[l],
                          dropout_p=dropout_p, group=enc.tp_group,
                          hash4=hash4)
    return enc.norm(x)


def encoder_stack_flash(enc: Encoder, x, mask, *, h: int = 8):
    """The long-video route, eval in "key_query" mode: every layer as
    `encoder_layer`, its attention through kernel 11.  x: [B, T, D]."""
    _check_tp(enc, None, x)
    for layer in enc.layers:
        x = encoder_layer(layer, x, mask, h=h // enc.tp_size,
                          mask_mode="key_query", flash=True,
                          group=enc.tp_group)
    return enc.norm(x)


def _check_tp(enc: Encoder, seeds, x) -> None:
    if enc.tp_group is not None and (
            seeds is not None or needs_grad(x, *enc.parameters())):
        raise NotImplementedError(
            "a tensor-parallel encoder runs eval only: no dropout seeds, no "
            "gradients (run it under torch.inference_mode())")


def encoder_stack(enc: Encoder, x, mask=None, *, h: int = 8,
                  mask_mode: str = "query", seeds=None,
                  dropout_p: float = DROPOUT, backward: str = "perlayer",
                  hash4: bool = False):
    """Full N-layer pre-norm encoder with final norm.  x: [B, T, D];
    seeds: the [N, 4] dropout seed table (or [N, 4, 2] threefry keys) in
    training, None in eval; hash4: the table's seeds are the "hash4"
    stream's (ops/basic.py `site_seed`);
    backward: the training backward on the card, "perlayer" (kernel 4) or
    "stack" (kernel 5).  A tensor-parallel encoder takes the flash route
    in "key_query" mode with a mask, else the plain one."""
    if enc.tp_group is not None:
        if mask is not None and mask_mode == "key_query":
            return encoder_stack_flash(enc, x, mask, h=h)
        return encoder_stack_plain(enc, x, mask, h=h, mask_mode=mask_mode,
                                   seeds=seeds, dropout_p=dropout_p,
                                   hash4=hash4)
    route = encoder_route(use_kernel(x) and mask is not None, x.shape[1],
                          mask_mode, seeds is not None, backward,
                          needs_grad(x, *enc.parameters()),
                          threefry=prng.is_keys(seeds))
    if route == "fused":
        from .cuda.encoder import encoder_stack_fused
        return encoder_stack_fused(enc, x, mask, h=h)
    if route == "flash":
        return encoder_stack_flash(enc, x, mask, h=h)
    if route in ("train", "train_stack"):
        from .cuda.encoder_train import encoder_stack_train
        if seeds is None:  # differentiable eval: the training kernels at p = 0
            seeds = torch.zeros(len(enc.layers), 4, dtype=torch.int64)
            dropout_p = 0.0
        y = encoder_stack_train(enc, x, mask, h=h, p=dropout_p, seeds=seeds,
                                backward=backward, hash4=hash4)
        return enc.norm(y.to(x.dtype))
    return encoder_stack_plain(enc, x, mask, h=h, mask_mode=mask_mode,
                               seeds=seeds, dropout_p=dropout_p, hash4=hash4)
