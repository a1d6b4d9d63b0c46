"""Kernels 4 and 5's bf16 wgmma path (d_k in {16, 32}, D in {128, 256}, F =
128), its arithmetic emulated block by block on the CPU; the plain
version's new bf16 rounding points; the choice of path; and the build's
spill report, which chip_smoke.py's gate reads.

The CUDA kernels cannot run here, so `_blockwise` repeats their arithmetic
in torch, in float32 with bf16 roundings where the kernels round:
  * front: LN1 (mean, unbiased variance, times the reciprocal of std +
    1e-6) rounded to bf16; q | k | v as bf16 products with float32 sums,
    q scaled by 1/sqrt(d_k) before its round; LN1's row mean and variance
    kept for the backward;
  * attention forward in 64-key tiles: scores in float32, -1e9 for masked
    keys, a running max from -1e9, p = 2^(fma(s, log2 e, -m log2 e)), the
    sum over every p, p v over the kept p times the dropout scale (1 /
    keep_p in float32, at every site) rounded to bf16, the output times the
    reciprocal of the sum; each row's max and sum kept;
  * middle chain: x1 = x + site-1 dropout(o Wo^T + bo); LN2; midp; the
    stored hidden round(dropout(relu(midp))); dff = site-3 dropout(dy),
    rounded for dmid = dff W2; dmidp = relu'(midp) site-2 dropout'(dmid),
    rounded for dxn2 = dmidp W1; LN2's VJP from its row sums; dx1 = dy +
    LN2'(dxn2); dattn = site-1 dropout'(dx1), rounded for do = dattn Wo,
    stored in bf16;
  * attention backward: P = 2^(fma(s, log2 e, -m log2 e)) / sum rebuilt
    from the row statistics, dP = do v^T over the kept keys / keep_p, D_i
    = sum P dP / sum P, ds = P (dP - D) (0 at a masked key, whose score is
    the constant -1e9), dq = round(round(ds / sqrt(d_k)) k), dk =
    round(round(ds)^T q), dv = round(round(P_kept / keep_p)^T do);
  * back chain: dxn1 = [dq | dk | dv] [Wq; Wk; Wv], LN1's VJP from the
    front's statistics, dx = dx1 + LN1'(dxn1);
  * every weight gradient G^T X summed over chunks of 1,024 rows, the
    chunks' partials added in order (compensated); every bias and LN
    gradient summed over blocks of 64 rows, the blocks added in order
    (compensated).
It is held to the competitive bound err <= 2 * err(competitor - fp64) +
1e-6, output by output, against two competitors:
  * `encoder_layer_bwd_plain` in bf16 (the kernels' CPU path), both
    measured against the plain version in float64 on the same bf16
    parameters and float32 x and dy, on every row (dy is not masked, so
    the video with no key carries gradient too), as
    `verify.check_encoder_layer_bwd` does on the card;
  * the Pallas `_layer_bwd_call` in interpret mode in bf16 on the same
    numpy-seeded parameters, carried across by `load_jax_params`, on the
    valid rows (dy masked: the Pallas kernel pads T to a multiple of 8, and
    a video with no key attends over its padding too).

Cases: d_k 16 (D = 128) and 32 (D = 256), h = 8, F = 128, one layer, B = 3
with lengths (T, 0, ceil(T / 2)): a video with no valid key; T in {1, 137,
160, 300} (one key; ragged tiles; the training shape; five tiles); p in
{0.1, 0}.
"""

import importlib.util
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_transformer_tpu.ops.pallas import encoder as jenc
from multimodal_transformer_tpu_torch.ops.attention import Encoder
from multimodal_transformer_tpu_torch.ops.basic import (dropout,
                                                        hash_keep_mask)
from multimodal_transformer_tpu_torch.ops.cuda import _build
from multimodal_transformer_tpu_torch.ops.cuda import encoder as enc_k
from multimodal_transformer_tpu_torch.ops.cuda import encoder_train as et
from multimodal_transformer_tpu_torch.ops.cuda.encoder import NEG_INF
from multimodal_transformer_tpu_torch.ops.norm import layer_norm
from multimodal_transformer_tpu_torch.utils.params import load_jax_params
from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401


H, F = 8, 128
LOG2E = 1.4426950408889634
BF16 = torch.bfloat16
CHUNK_ROWS, BLOCK_ROWS = 1024, 64
GRAD_NAMES = ("ln1.a", "ln1.b", "q.w", "q.b", "k.w", "k.b", "v.w", "v.b",
              "out.w", "out.b", "ln2.a", "ln2.b", "ff1.w", "ff1.b", "ff2.w",
              "ff2.b")


def _lin(rs, fan_in, fan_out):
    k = fan_in ** -0.5
    return {"weight": rs.uniform(-k, k, (fan_out, fan_in)).astype(np.float32),
            "bias": rs.uniform(-k, k, fan_out).astype(np.float32)}


def _norm(rs, D):
    return {"a_2": (1 + 0.1 * rs.randn(D)).astype(np.float32),
            "b_2": (0.1 * rs.randn(D)).astype(np.float32)}


def _case(seed, D, T):
    """One layer's numpy-seeded parameters (JAX tree and the bf16 port
    tensors), x, dy [B, T, D] float32, the key mask and the seeds."""
    rs = np.random.RandomState(seed)
    layer = {"self_attn": {"linears": [_lin(rs, D, D) for _ in range(4)]},
             "feed_forward": {"w_1": _lin(rs, D, F), "w_2": _lin(rs, F, D)},
             "sublayer": [{"norm": _norm(rs, D)}, {"norm": _norm(rs, D)}]}
    lens = [T, 0, (T + 1) // 2]
    x = rs.randn(len(lens), T, D).astype(np.float32)
    dy = rs.randn(len(lens), T, D).astype(np.float32)
    mask = np.zeros((len(lens), T), np.float32)
    for b, n in enumerate(lens):
        mask[b, :n] = 1.0
    seeds = rs.randint(0, 2 ** 32, size=4, dtype=np.uint64).astype(np.int64)
    enc = load_jax_params(Encoder(D, F, 1),
                          {"layers": [layer], "norm": _norm(rs, D)})
    lp = [t.detach().to(BF16) for t in et._layer_tensors(enc.layers[0])]
    return layer, lp, x, dy, mask, seeds


def _bf(t):
    return t.to(BF16).float()


def _scale(p):
    """The kernels' dropout scale: 1 / keep_p in float32."""
    return 1 / torch.tensor(1.0 - p, dtype=torch.float32)


def _drop(t, seed, p):
    """A row site's dropout at the flat positions of t [B, T, width], kept
    values times the scale."""
    idx = torch.arange(t.numel()).view(t.shape)
    return torch.where(hash_keep_mask(int(seed), idx, p), t * _scale(p),
                       torch.zeros(()))


def _kahan(parts):
    """parts [n, ...] added in order, compensated, in float32."""
    s = torch.zeros_like(parts[0])
    comp = torch.zeros_like(parts[0])
    for v in parts:
        y = v - comp
        t = s + y
        comp = (t - s) - y
        s = t
    return s


def _colsum(t):
    """Column sums of t [M, width] over blocks of 64 rows, then the blocks
    in order."""
    M, W = t.shape
    nb = -(-M // BLOCK_ROWS)
    pad = torch.zeros(nb * BLOCK_ROWS, W)
    pad[:M] = t
    return _kahan(pad.view(nb, BLOCK_ROWS, W).sum(1))


def _wgrad(G, X):
    """G^T X over chunks of 1,024 rows, the partials added in order."""
    M = G.shape[0]
    return _kahan(torch.stack([G[r:r + CHUNK_ROWS].T @ X[r:r + CHUNK_ROWS]
                               for r in range(0, M, CHUNK_ROWS)]))


def _ln(x, a, b):
    D = x.shape[-1]
    mean = x.sum(-1, keepdim=True) / D
    d = x - mean
    var = (d * d).sum(-1, keepdim=True) / (D - 1)
    return a * d * (1 / (torch.sqrt(var) + 1e-6)) + b, mean, var


def _ln_vjp(g, x, a, mean, var):
    """The kernels' LayerNorm VJP from the row's three sums: (dx, g d inv)."""
    D = x.shape[-1]
    d = x - mean
    ga = g * a
    sgad, sga, sd = ((ga * d).sum(-1, keepdim=True), ga.sum(-1, keepdim=True),
                     d.sum(-1, keepdim=True))
    std = torch.sqrt(var)
    inv = 1 / (std + 1e-6)
    dden = -sgad * inv * inv
    dvar = torch.where(var > 0, dden / (2 * std), torch.zeros_like(var))
    coef = 2 * dvar / (D - 1)
    mdd = (sga * inv + coef * sd) / D
    return (g * a * inv + d * coef) - mdd, g * d * inv


def _prob_keep(seed, p, B, h, T, q0, nq, k0, nk):
    """Keep bits of probabilities (queries q0.., keys k0..) at their flat
    [B, h, T, T] positions."""
    b = torch.arange(B)[:, None, None, None]
    hd = torch.arange(h)[None, :, None, None]
    q = torch.arange(q0, q0 + nq)[None, None, :, None]
    k = torch.arange(k0, k0 + nk)[None, None, None, :]
    idx = ((b * h + hd) * T + q) * T + k
    return hash_keep_mask(int(seed), idx, p)


def _blockwise(lp, x, dy, kmask, seeds, p, h=H):
    """Kernel 4's wgmma path on bf16 lp, float32 x, dy [B, T, D] and kmask
    [B, T]: (dx, the 16 gradients)."""
    (ln1a, ln1b, wq, bq, wk, bk, wv, bv, wo, bo, ln2a, ln2b,
     w1, b1, w2, b2) = [t.float() for t in lp]
    B, T, D = x.shape
    d_k, M, sc = D // h, B * T, _scale(p)
    inv_sqrt = torch.tensor(1.0) / torch.sqrt(torch.tensor(float(d_k)))
    heads = lambda t: t.view(B, T, h, d_k).transpose(1, 2)
    rows = lambda t: t.transpose(1, 2).reshape(B, T, D)
    # front
    xn1f, mean1, var1 = _ln(x, ln1a, ln1b)
    xn1 = _bf(xn1f)
    q = _bf((xn1 @ wq.T + bq) * inv_sqrt)
    k = _bf(xn1 @ wk.T + bk)
    v = _bf(xn1 @ wv.T + bv)
    qh, kh, vh = heads(q), heads(k), heads(v)
    keep_key = (kmask != 0)[:, None, None, :]
    # attention forward over 64-key tiles
    m = torch.full((B, h, T, 1), NEG_INF)
    l = torch.zeros(B, h, T, 1)
    o = torch.zeros(B, h, T, d_k)
    for k0 in range(0, T, 64):
        n = min(64, T - k0)
        s = qh @ kh[:, :, k0:k0 + n].transpose(-1, -2)
        s = s.masked_fill(~keep_key[..., k0:k0 + n], NEG_INF)
        mn = torch.maximum(m, s.amax(-1, keepdim=True))
        a = torch.exp2((m - mn) * LOG2E)
        ml = mn * torch.tensor(LOG2E)
        pr = torch.exp2((s.double() * LOG2E - ml.double()).float())
        l = l * a + pr.sum(-1, keepdim=True)
        kept = _prob_keep(seeds[0], p, B, h, T, 0, T, k0, n)
        pd = torch.where(kept, pr * sc, torch.zeros_like(pr))
        o = o * a + _bf(pd) @ vh[:, :, k0:k0 + n]
        m = mn
    ml, il = m * torch.tensor(LOG2E), 1 / l
    o = _bf(rows(o * il))
    # middle chain
    x1 = x + _drop(o @ wo.T + bo, seeds[1], p)
    xn2f, mean2, var2 = _ln(x1, ln2a, ln2b)
    xn2 = _bf(xn2f)
    midp = xn2 @ w1.T + b1
    mid = _bf(_drop(torch.relu(midp), seeds[2], p))
    dff = _drop(dy, seeds[3], p)
    dmid = _bf(dff) @ w2
    dmidp = torch.where(midp > 0, _drop(dmid, seeds[2], p),
                        torch.zeros_like(dmid))
    g2 = _bf(dmidp) @ w1
    dx1_ln, gdn2 = _ln_vjp(g2, x1, ln2a, mean2, var2)
    dx1 = dy + dx1_ln
    dattn = _drop(dx1, seeds[1], p)
    do = _bf(_bf(dattn) @ wo)
    # attention backward, every key at once (its sums are the tiles' in
    # the kernel; the order is not emulated)
    s = (qh @ kh.transpose(-1, -2)).masked_fill(~keep_key, NEG_INF)
    P = torch.exp2((s.double() * LOG2E - ml.double()).float()) * il
    dpv = heads(do) @ vh.transpose(-1, -2)
    kept = _prob_keep(seeds[0], p, B, h, T, 0, T, 0, T)
    dp = torch.where(kept, dpv * sc, torch.zeros_like(dpv))
    psum = P.sum(-1, keepdim=True)
    Di = torch.where(psum > 0, (P * dp).sum(-1, keepdim=True) / psum,
                     torch.zeros_like(psum))
    ds = torch.where(keep_key, P * (dp - Di), torch.zeros(()))
    dq = _bf(rows(_bf(ds * inv_sqrt) @ kh))
    dk = _bf(rows(_bf(ds).transpose(-1, -2) @ qh))
    pd = torch.where(kept, P * sc, torch.zeros_like(P))
    dv = _bf(rows(_bf(pd).transpose(-1, -2) @ heads(do)))
    # back chain
    g1 = dq @ wq + dk @ wk + dv @ wv
    dx_ln, gdn1 = _ln_vjp(g1, x, ln1a, mean1, var1)
    dx = dx1 + dx_ln
    flat = lambda t: t.reshape(M, -1)
    grads = [_colsum(flat(gdn1)), _colsum(flat(g1)),
             _wgrad(flat(dq), flat(xn1)), _colsum(flat(dq)),
             _wgrad(flat(dk), flat(xn1)), _colsum(flat(dk)),
             _wgrad(flat(dv), flat(xn1)), _colsum(flat(dv)),
             _wgrad(flat(_bf(dattn)), flat(o)), _colsum(flat(dattn)),
             _colsum(flat(gdn2)), _colsum(flat(g2)),
             _wgrad(flat(_bf(dmidp)), flat(xn2)), _colsum(flat(dmidp)),
             _wgrad(flat(_bf(dff)), flat(mid)), _colsum(flat(dff))]
    return dx, grads


def _err(a, ref, rows=None):
    d = (a.double() - ref.double()).abs()
    return (d if rows is None else d[rows]).max().item()


def _plain(lp, x, dy, kmask, seeds, p):
    return et.encoder_layer_bwd_plain(lp, x, dy, kmask, seeds, p, H)


def _ref(lp, x, dy, kmask, seeds, p):
    return et.encoder_layer_bwd_plain([t.double() for t in lp], x.double(),
                                      dy.double(), kmask.double(), seeds, p, H)


def _pallas(layer, x, dy, mask, seeds, p, D):
    """The Pallas layer backward in bf16, interpret mode: (dx, grads in the
    port's order), T padded to a multiple of 8 as the JAX package pads it."""
    B, T0, _ = x.shape
    T = T0 + (-T0) % 8
    pad = lambda a: np.pad(a, ((0, 0), (0, T - T0)) + ((0, 0),) * (a.ndim - 2))
    w = jenc._pack_weights({"layers": [layer],
                            "norm": {"a_2": jnp.zeros(D), "b_2": jnp.zeros(D)}},
                           jnp.bfloat16)
    wl = {k: v for k, v in w.items() if k != "fnorm"}
    d_k = D // H
    av_group = max(1, min(H, 128 // d_k))
    while H % av_group:
        av_group -= 1
    table = jnp.asarray(seeds.astype(np.uint32).view(np.int32)[None, :])
    dx, gl = jenc._layer_bwd_call(
        wl, table, jnp.asarray(pad(x)), jnp.asarray(pad(dy)),
        jnp.asarray(pad(mask)), h=H, dropout_p=p, T0=T0, B=B,
        cdt=jnp.bfloat16, av_group=av_group, interpret=True, tile_b=1)
    g = jenc._unpack_layer_grads(gl, D)
    lins = g["self_attn"]["linears"]
    ff = g["feed_forward"]
    n1, n2 = g["sublayer"][0]["norm"], g["sublayer"][1]["norm"]
    grads = [n1["a_2"], n1["b_2"]]
    for lin in lins:
        grads += [lin["weight"], lin["bias"]]
    grads[10:10] = [n2["a_2"], n2["b_2"]]
    grads += [ff["w_1"]["weight"], ff["w_1"]["bias"], ff["w_2"]["weight"],
              ff["w_2"]["bias"]]
    return (torch.from_numpy(np.array(dx, np.float32)[:, :T0]),
            [torch.from_numpy(np.array(t, np.float32)) for t in grads])


def _holds(got, comp, ref, rows):
    """Each output of got within the bound of comp, both against ref; dx on
    `rows` (None: every row)."""
    outs = ("dx",) + GRAD_NAMES
    for name, a, c, r in zip(outs, [got[0]] + got[1], [comp[0]] + comp[1],
                             [ref[0]] + ref[1]):
        rr = rows if name == "dx" else None
        err, comp_err = _err(a, r, rr), _err(c, r, rr)
        assert err <= 2 * comp_err + 1e-6, (name, err, comp_err)


@pytest.mark.parametrize("p", [0.1, 0.0])
@pytest.mark.parametrize("T", [1, 137, 160, 300])
@pytest.mark.parametrize("d_k", [16, 32])
def test_blockwise_emulation_within_bound_of_plain_and_pallas(d_k, T, p):
    D = H * d_k
    layer, lp, x, dy, mask, seeds = _case(1000 * d_k + T, D, T)
    assert enc_k.kernel_path(BF16, d_k, D, F) == enc_k.PATH_WGMMA
    xt, dyt, km = map(torch.from_numpy, (x, dy, mask))
    got = _blockwise(lp, xt, dyt, km, seeds, p)
    assert all(bool(torch.isfinite(t).all()) for t in [got[0]] + got[1])
    _holds(got, _plain(lp, xt, dyt, km, seeds, p),
           _ref(lp, xt, dyt, km, seeds, p), None)

    dym = dy * mask[..., None]
    dymt = torch.from_numpy(dym)
    got = _blockwise(lp, xt, dymt, km, seeds, p)
    _holds(got, _pallas(layer, x, dym, mask, seeds, p, D),
           _ref(lp, xt, dymt, km, seeds, p), torch.from_numpy(mask > 0))


def test_attention_emulation_of_a_video_with_no_key_is_uniform():
    """Every score of a video with no key is the max -1e9, so the rebuilt
    probabilities are 1 / T each, whatever the rounding of -1e9 log2 e."""
    T = 300
    s = torch.full((1, 1, 1, T), NEG_INF)
    ml = torch.tensor(NEG_INF) * torch.tensor(LOG2E)
    pr = torch.exp2((s.double() * LOG2E - ml.double()).float())
    P = pr * (1 / pr.sum())
    assert torch.allclose(P, torch.full_like(P, 1 / T), rtol=1e-6)


# ---------------------------------------------------------------------------
# The plain version before its bf16 rounding points moved (as it was), for
# the two tests below.

def _old_layer_train_plain(lp, x, kmask, seeds, p, h):
    from multimodal_transformer_tpu_torch.ops.basic import dropout_with_idx
    (ln1a, ln1b, wq, bq, wk, bk, wv, bv, wo, bo, ln2a, ln2b,
     w1, b1, w2, b2) = lp
    cdt = torch.float64 if x.dtype == torch.float64 else wq.dtype
    acc = x.dtype
    B, T, D = x.shape
    d_k = D // h
    s0, s1, s2, s3 = (int(s) for s in seeds)

    def c(t):
        return t.to(cdt).to(acc)

    def mm(a, w, b):
        return c(a) @ c(w).T + c(b)

    def heads(t):
        return c(t).view(B, T, h, d_k).transpose(1, 2)

    inv_sqrt_dk = 1.0 / torch.tensor(float(d_k), dtype=acc).sqrt().item()
    xn = layer_norm(x, c(ln1a), c(ln1b)).to(cdt)
    q = (mm(xn, wq, bq) * torch.tensor(inv_sqrt_dk, dtype=acc)).to(cdt)
    k = mm(xn, wk, bk).to(cdt)
    v = mm(xn, wv, bv).to(cdt)
    s = heads(q) @ heads(k).transpose(-2, -1)
    s = s.masked_fill(kmask[:, None, None, :] == 0, NEG_INF)
    prob = torch.softmax(s, dim=-1)
    if p > 0.0:
        idx = torch.arange(prob.numel(), dtype=torch.int64,
                           device=x.device).view(prob.shape)
        prob = dropout_with_idx(prob, s0, p, idx)
    o = (c(prob.to(cdt)) @ heads(v)).transpose(1, 2).reshape(B, T, D)
    x1 = x + dropout(mm(o.to(cdt), wo, bo), s1, p)
    xn2 = layer_norm(x1, c(ln2a), c(ln2b)).to(cdt)
    mid = dropout(torch.relu(mm(xn2, w1, b1)), s2, p).to(cdt)
    return x1 + dropout(mm(mid, w2, b2), s3, p)


def _old_layer_bwd_plain(lp, x_l, dy, kmask, seeds, p, h):
    acc = x_l.dtype
    with torch.enable_grad():
        x = x_l.detach().requires_grad_()
        ps = [t.detach().to(acc).requires_grad_() for t in lp]
        ps_in = ps if acc == torch.float64 else [t.to(lp[2].dtype) for t in ps]
        y = _old_layer_train_plain(ps_in, x, kmask, seeds, p, h)
        grads = torch.autograd.grad(y, [x] + ps, dy)
    return grads[0], list(grads[1:])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("p", [0.1, 0.0])
def test_plain_backward_in_float32_and_float64_is_unchanged(dtype, p):
    """Only bf16 moved: float32 and float64 give the same bits as before."""
    _, lp, x, dy, mask, seeds = _case(7, 128, 37)
    lp = [t.to(dtype) for t in lp]
    args = (torch.from_numpy(x).to(dtype if dtype == torch.float64 else
                                   torch.float32),
            torch.from_numpy(dy), torch.from_numpy(mask), seeds, p, H)
    if dtype == torch.float64:
        args = (args[0], args[1].double(), args[2].double()) + args[3:]
    new = et.encoder_layer_bwd_plain(lp, *args)
    old = _old_layer_bwd_plain(lp, *args)
    assert torch.equal(new[0], old[0])
    assert all(torch.equal(a, b) for a, b in zip(new[1], old[1]))


def test_plain_bf16_is_no_farther_from_pallas_than_before():
    """The bf16 plain backward at the TPU kernel's rounding points against
    the Pallas bf16 backward (interpret mode), on the valid rows, beside the
    plain backward before the change, d_k = 32, T = 160, p = 0.1.  Measured
    on the CPU (max |plain - Pallas|, before -> now): dx 5.2e-3 -> 1.6e-4,
    q.w 9.7e-3 -> 7.4e-4, v.b 1.1e-1 -> 6.7e-3, out.b 1.2e-1 -> 1.2e-5,
    ln2.a 5.3e-2 -> 9.2e-5, ff1.w 1.9e-1 -> 2.4e-2, ff2.b 1.1e-1 -> 7.6e-6;
    every output closer than before."""
    D, T, p = 256, 160, 0.1
    layer, lp, x, dy, mask, seeds = _case(11, D, T)
    dy = dy * mask[..., None]
    xt, dyt, km = map(torch.from_numpy, (x, dy, mask))
    want = _pallas(layer, x, dy, mask, seeds, p, D)
    new = _plain(lp, xt, dyt, km, seeds, p)
    old = _old_layer_bwd_plain(lp, xt, dyt, km, seeds, p, H)
    valid = torch.from_numpy(mask > 0)
    for name, w, n, o in zip(("dx",) + GRAD_NAMES, [want[0]] + want[1],
                             [new[0]] + new[1], [old[0]] + old[1]):
        rows = valid if name == "dx" else None
        assert _err(n, w, rows) <= _err(o, w, rows), name


# ---------------------------------------------------------------------------
# the path choice

@pytest.mark.parametrize("dtype,d_k,D,F_,path", [
    (torch.bfloat16, 32, 256, 128, enc_k.PATH_WGMMA),
    (torch.bfloat16, 16, 128, 128, enc_k.PATH_WGMMA),
    (torch.bfloat16, 16, 256, 128, enc_k.PATH_WGMMA),
    (torch.bfloat16, 32, 128, 128, enc_k.PATH_WGMMA),
    (torch.bfloat16, 32, 256, 256, enc_k.PATH_FMA),
    (torch.bfloat16, 2, 16, 128, enc_k.PATH_FMA),
    (torch.bfloat16, 8, 64, 128, enc_k.PATH_FMA),
    (torch.bfloat16, 16, 64, 32, enc_k.PATH_FMA),
    (torch.float32, 32, 256, 128, enc_k.PATH_FMA),
    (torch.float32, 16, 128, 128, enc_k.PATH_FMA)])
def test_backward_path_of_dtype_d_k_and_widths(dtype, d_k, D, F_, path):
    assert enc_k.kernel_path(dtype, d_k, D, F_, what="encoder backward") \
        == path


@pytest.mark.parametrize("dtype,d_k,error", [
    (torch.bfloat16, 12, ValueError), (torch.float32, 64, ValueError),
    (torch.float16, 32, TypeError), (torch.float64, 16, TypeError)])
def test_backward_path_refuses_what_no_path_takes(dtype, d_k, error):
    with pytest.raises(error, match="encoder backward"):
        enc_k.kernel_path(dtype, d_k, 8 * d_k, 128, what="encoder backward")


class _Lib:
    """A stand-in library whose C path query answers `path`."""

    def __init__(self, path):
        self.path = path

    def mmtx_encoder_bwd_path(self, dtype, D, h, F):
        return self.path

    def __getattr__(self, name):
        pytest.fail(f"{name} reached: the wrapper should have raised")


def _layer_args(D=256, T=5, offset=False):
    lp = [t.detach().to(BF16) for t in
          et._layer_tensors(Encoder(D, F, 1).layers[0])]
    if offset:  # q's weight one element off a 16-byte boundary
        lp[2] = torch.zeros(D * D + 1, dtype=BF16)[1:].view(D, D)
    x = torch.zeros(2, T, D)
    return lp, x, torch.zeros(2, T, D), torch.ones(2, T), torch.zeros(4)


@pytest.mark.parametrize("stack", [False, True])
def test_wrapper_raises_when_the_library_takes_another_path(monkeypatch,
                                                            stack):
    monkeypatch.setattr(et, "use_kernel", lambda t: True)
    monkeypatch.setattr(_build, "load", lambda *a, **k: _Lib(0))
    lp, x, dy, km, seeds = _layer_args()
    with pytest.raises(RuntimeError, match="not kernel_path's 1"):
        if stack:
            et.encoder_stack_bwd(lp, x[None], dy, km, seeds[None], 0.1, H)
        else:
            et.encoder_layer_bwd(lp, x, dy, km, seeds, 0.1, H)


def test_wrapper_refuses_unaligned_parameters_on_the_wgmma_path(monkeypatch):
    monkeypatch.setattr(et, "use_kernel", lambda t: True)
    monkeypatch.setattr(_build, "load", lambda *a, **k: _Lib(1))
    lp, x, dy, km, seeds = _layer_args(offset=True)
    with pytest.raises(ValueError, match="16-byte aligned"):
        et.encoder_layer_bwd(lp, x, dy, km, seeds, 0.1, H)


# ---------------------------------------------------------------------------
# the build's spill report

def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ptxas_entry(symbol: str, stores: int, loads: int) -> str:
    return (f"ptxas info    : Compiling entry function '{symbol}' for "
            f"'sm_90a'\nptxas info    : Function properties for {symbol}\n"
            f"    0 bytes stack frame, {stores} bytes spill stores, {loads} "
            "bytes spill loads\nptxas info    : Used 128 registers\n")


def test_spill_gate_reads_every_kernel_and_fails_on_a_log_without_them():
    cs = _chip_smoke()
    kernels = [k for k, _ in cs.ENC_BWD_SASS] + ["enc_bwd10sum_kernel"]
    entries = [_ptxas_entry(f"_ZN4mmtx7{k}ILi128EEEvNS0_4ArgsE", 0, 0)
               for k in kernels]
    assert cs.spill_gate("".join(entries), cs.ENC_BWD, kernels) == 0
    spilled = entries[:-1] + [_ptxas_entry(
        "_ZN4mmtx7enc_bwd10sum_kernelENS0_7SumArgsE", 8, 12)]
    assert cs.spill_gate("".join(spilled), cs.ENC_BWD, kernels) == 20
    for log in ("", "".join(entries[1:])):  # a cached build; one missing
        with pytest.raises(cs.SmokeFailure, match="cannot check"):
            cs.spill_gate(log, cs.ENC_BWD, kernels)


def test_verbose_build_reads_the_kept_log_or_compiles_again(monkeypatch,
                                                           tmp_path):
    lib = tmp_path / "libmmtx_0.so"
    lib.write_bytes(b"")
    monkeypatch.setattr(_build, "library_path", lambda: lib)
    monkeypatch.setattr(_build, "build_log", "")
    assert _build.build() == lib  # cached, not verbose: nothing to read
    monkeypatch.setattr(_build, "find_nvcc", lambda: pytest.fail("compiled"))
    lib.with_suffix(".log").write_text("ptxas info    : kept\n")
    assert _build.build(verbose=True) == lib
    assert _build.build_log == "ptxas info    : kept\n"
    lib.with_suffix(".log").unlink()

    def no_nvcc():
        raise _build.KernelBuildError("nvcc not found")

    monkeypatch.setattr(_build, "find_nvcc", no_nvcc)
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.build(verbose=True)
