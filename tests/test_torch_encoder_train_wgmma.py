"""Kernel 3's bf16 wgmma path (d_k in {16, 32}, D in {128, 256}, F = 128),
its arithmetic emulated block by block on the CPU; the plain version's
float32 and float64 forward, unchanged; the choice of path; and the spill
gate's reading of the training chain's symbols.

The CUDA kernels cannot run here, so `_blockwise` repeats their arithmetic
in torch, in float32 with bf16 roundings where the kernels round:
  * layer 0's row chain: x (bf16) into the fp32 residual rows, which are
    saved[0];
  * per layer, the row chain's LN1 (mean, unbiased variance, times the
    reciprocal of std + 1e-6) rounded to bf16; q | k | v as bf16 products
    with float32 sums, q scaled by 1/sqrt(d_k) before its round;
  * kernel 4's attention forward in 64-key tiles: scores in float32, -1e9
    for masked keys, a running max from -1e9, p = 2^(fma(s, log2 e, -m log2
    e)), the sum over every p, p v over the kept p times the dropout scale
    (1 / keep_p in float32, at every site) rounded to bf16, the output
    times the reciprocal of the sum, rounded to bf16;
  * the row chain: x1 = x + site-1 dropout(o Wo^T + bo); LN2; FFN1, ReLU,
    site-2 dropout, rounded to bf16; x1 + site-3 dropout(FFN2), the next
    layer's saved input or, on the last layer, the output, in float32
    (no final norm).
A chain's 64 rows are independent of each other, so the emulation takes
every row at once; the order of a row's sums (the kernel's quad order) is
not emulated.  It is held to the competitive bound err <= 2 * err(competitor
- fp64) + 1e-6, on `out` and on every `saved[l]`, against two competitors:
  * `encoder_stack_train_fwd_plain` in bf16 (the kernel's CPU path), both
    measured against the plain version in float64 on the same bf16
    parameters and input, on every row (both compute the same function
    there), as `verify.check_encoder_train_fwd` does on the card;
  * the Pallas `_train_fwd_impl` in interpret mode in bf16 on the same
    numpy-seeded parameters, carried across by `load_jax_params`, on the
    valid rows (the Pallas kernel pads T to a multiple of 8, and a video
    with no key attends over its padding too).

Cases: d_k 16 (D = 128) and 32 (D = 256), h = 8, F = 128, 2 layers, B = 3
with lengths (T, 0, ceil(T / 2)): a video with no valid key; T in {1, 137,
160, 300} (one key; ragged tiles; the training shape; five tiles); p in
{0.1, 0}.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_transformer_tpu.ops.pallas import encoder as jenc
from multimodal_transformer_tpu_torch.ops.attention import Encoder
from multimodal_transformer_tpu_torch.ops.basic import (dropout,
                                                        dropout_with_idx,
                                                        hash_keep_mask)
from multimodal_transformer_tpu_torch.ops.cuda import _build
from multimodal_transformer_tpu_torch.ops.cuda import encoder as enc_k
from multimodal_transformer_tpu_torch.ops.cuda import encoder_train as et
from multimodal_transformer_tpu_torch.ops.cuda.encoder import NEG_INF
from multimodal_transformer_tpu_torch.ops.norm import layer_norm
from multimodal_transformer_tpu_torch.utils.params import load_jax_params
from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401


H, F, N_LAYERS = 8, 128, 2
LOG2E = 1.4426950408889634
BF16 = torch.bfloat16


def _lin(rs, fan_in, fan_out):
    k = fan_in ** -0.5
    return {"weight": rs.uniform(-k, k, (fan_out, fan_in)).astype(np.float32),
            "bias": rs.uniform(-k, k, fan_out).astype(np.float32)}


def _norm(rs, D):
    return {"a_2": (1 + 0.1 * rs.randn(D)).astype(np.float32),
            "b_2": (0.1 * rs.randn(D)).astype(np.float32)}


def _case(seed, D, T):
    """The stack's numpy-seeded parameters (JAX trees and the bf16 port
    tensors), x [B, T, D] in bf16, the key mask and the seeds [N, 4]."""
    rs = np.random.RandomState(seed)
    layers = [{"self_attn": {"linears": [_lin(rs, D, D) for _ in range(4)]},
               "feed_forward": {"w_1": _lin(rs, D, F), "w_2": _lin(rs, F, D)},
               "sublayer": [{"norm": _norm(rs, D)}, {"norm": _norm(rs, D)}]}
              for _ in range(N_LAYERS)]
    lens = [T, 0, (T + 1) // 2]
    x = rs.randn(len(lens), T, D).astype(np.float32)
    mask = np.zeros((len(lens), T), np.float32)
    for b, n in enumerate(lens):
        mask[b, :n] = 1.0
    seeds = rs.randint(0, 2 ** 32, size=(N_LAYERS, 4),
                       dtype=np.uint64).astype(np.int64)
    enc = load_jax_params(Encoder(D, F, N_LAYERS),
                          {"layers": layers, "norm": _norm(rs, D)})
    params = [t.detach().to(BF16) for layer in enc.layers
              for t in et._layer_tensors(layer)]
    return layers, params, torch.from_numpy(x).to(BF16), mask, seeds


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


def _ln(x, a, b):
    """LN through the reciprocal of std + eps, as the row chain computes it."""
    D = x.shape[-1]
    mean = x.sum(-1, keepdim=True) / D
    d = x - mean
    var = (d * d).sum(-1, keepdim=True) / (D - 1)
    return a * d * (1 / (torch.sqrt(var) + 1e-6)) + b


def _prob_keep(seed, p, B, h, T, k0, nk):
    """Keep bits of the probabilities of keys k0.. at their flat [B, h, T,
    T] positions."""
    b = torch.arange(B)[:, None, None, None]
    hd = torch.arange(h)[None, :, None, None]
    q = torch.arange(T)[None, None, :, None]
    k = torch.arange(k0, k0 + nk)[None, None, None, :]
    return hash_keep_mask(int(seed), ((b * h + hd) * T + q) * T + k, p)


def _attention(q, k, v, kmask, seed, p, h):
    """Kernel 4's attention forward on bf16 q (scaled), k, v [B, T, D]."""
    B, T, D = q.shape
    d_k = D // h
    qh, kh, vh = (t.view(B, T, h, d_k).transpose(1, 2) for t in (q, k, v))
    keep_key = (kmask != 0)[:, None, None, :]
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
        # fma(s, log2 e, -m log2 e): one rounding, from float64
        pr = torch.exp2((s.double() * LOG2E - ml.double()).float())
        l = l * a + pr.sum(-1, keepdim=True)
        kept = _prob_keep(seed, p, B, h, T, k0, n)
        pd = torch.where(kept, pr * _scale(p), torch.zeros_like(pr))
        o = o * a + _bf(pd) @ vh[:, :, k0:k0 + n]
        m = mn
    return _bf((o * (1 / l)).transpose(1, 2).reshape(B, T, D))


def _blockwise(params, x, kmask, seeds, p, h=H):
    """Kernel 3's wgmma path on bf16 params, x [B, T, D] and kmask [B, T]:
    (out, saved [N, B, T, D]) in float32."""
    B, T, D = x.shape
    inv_sqrt = torch.tensor(1.0) / torch.sqrt(torch.tensor(float(D // h)))
    xr = x.float()
    saved = []
    for l in range(len(params) // et.N_PARAMS):
        (ln1a, ln1b, wq, bq, wk, bk, wv, bv, wo, bo, ln2a, ln2b,
         w1, b1, w2, b2) = [t.float() for t in
                            params[et.N_PARAMS * l:et.N_PARAMS * (l + 1)]]
        s0, s1, s2, s3 = seeds[l]
        saved.append(xr)
        xn1 = _bf(_ln(xr, ln1a, ln1b))
        q = _bf((xn1 @ wq.T + bq) * inv_sqrt)
        o = _attention(q, _bf(xn1 @ wk.T + bk), _bf(xn1 @ wv.T + bv), kmask,
                       s0, p, h)
        x1 = xr + _drop(o @ wo.T + bo, s1, p)
        xn2 = _bf(_ln(x1, ln2a, ln2b))
        mid = _bf(_drop(torch.relu(xn2 @ w1.T + b1), s2, p))
        xr = x1 + _drop(mid @ w2.T + b2, s3, p)
    return xr, torch.stack(saved)


def _pallas(layers, x, mask, seeds, p):
    """The Pallas training forward in bf16, interpret mode: (out, saved) on
    the unpadded [B, T] rows."""
    B, T = mask.shape
    table = jnp.asarray(seeds.astype(np.uint32).view(np.int32))
    out, saved = jenc._train_fwd_impl(
        layers, jnp.asarray(x.float().numpy(), jnp.bfloat16),
        jnp.asarray(mask[..., None]), h=H, dropout_p=p, seeds=table,
        interpret=True)
    return (torch.from_numpy(np.array(out, np.float32)),
            torch.from_numpy(np.array(saved, np.float32)[:, :B, :T]))


def _split(o):
    """out and each saved[l], by name."""
    return {"out": o[0], **{f"saved[{l}]": s for l, s in enumerate(o[1])}}


def _holds(got, comp, ref, rows=None):
    """Each output of got within the bound of comp, both against ref, on
    `rows` (None: every row)."""
    for name, g in _split(got).items():
        c, r = _split(comp)[name], _split(ref)[name]
        if rows is not None:
            g, c, r = g[rows], c[rows], r[rows]
        err = (g.double() - r.double()).abs().max().item()
        comp_err = (c.double() - r.double()).abs().max().item()
        assert err <= 2 * comp_err + 1e-6, (name, err, comp_err)


@pytest.mark.parametrize("p", [0.1, 0.0])
@pytest.mark.parametrize("T", [1, 137, 160, 300])
@pytest.mark.parametrize("d_k", [16, 32])
def test_blockwise_emulation_within_bound_of_plain_and_pallas(d_k, T, p):
    D = H * d_k
    layers, params, x, mask, seeds = _case(2000 * d_k + T, D, T)
    assert enc_k.kernel_path(BF16, d_k, D, F) == enc_k.PATH_WGMMA
    km = torch.from_numpy(mask)
    got = _blockwise(params, x, km, seeds, p)
    assert all(bool(torch.isfinite(t).all()) for t in got)
    assert torch.equal(got[1][0], x.float())
    ref = et.encoder_stack_train_fwd_plain([t.double() for t in params],
                                           x.double(), km.double(), seeds, p,
                                           H)
    _holds(got, et.encoder_stack_train_fwd_plain(params, x, km, seeds, p, H),
           ref)
    _holds(got, _pallas(layers, x, mask, seeds, p), ref,
           torch.from_numpy(mask > 0))


# ---------------------------------------------------------------------------
# The plain forward in float32 and float64 as it stands, frozen, for the
# test below: the bf16 wgmma path moved nothing in it.

def _frozen_layer_train_plain(lp, x, kmask, seeds, p, h):
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
    xn = c(layer_norm(x, c(ln1a), c(ln1b)))
    q = (mm(xn, wq, bq) * torch.tensor(inv_sqrt_dk, dtype=acc)).to(cdt)
    k = mm(xn, wk, bk).to(cdt)
    v = mm(xn, wv, bv).to(cdt)
    s = heads(q) @ heads(k).transpose(-2, -1)
    s = s.masked_fill(kmask[:, None, None, :] == 0, NEG_INF)
    prob = torch.softmax(s, dim=-1)
    if p > 0.0:
        idx = torch.arange(prob.numel(), dtype=torch.int64).view(prob.shape)
        prob = dropout_with_idx(prob, s0, p, idx)
    o = (c(prob) @ heads(v)).transpose(1, 2).reshape(B, T, D)
    x1 = x + dropout(mm(o, wo, bo), s1, p)
    xn2 = c(layer_norm(x1, c(ln2a), c(ln2b)))
    mid = c(dropout(torch.relu(mm(xn2, w1, b1)), s2, p))
    return x1 + dropout(mm(mid, w2, b2), s3, p)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("p", [0.1, 0.0])
def test_plain_forward_in_float32_and_float64_is_unchanged(dtype, p):
    _, params, x, mask, seeds = _case(5, 128, 37)
    params = [t.to(dtype) for t in params]
    xr, km = x.to(dtype), torch.from_numpy(mask).to(dtype)
    out, saved = et.encoder_stack_train_fwd_plain(params, xr, km, seeds, p, H)
    for l in range(N_LAYERS):
        assert torch.equal(saved[l], xr)
        xr = _frozen_layer_train_plain(
            params[et.N_PARAMS * l:et.N_PARAMS * (l + 1)], xr, km, seeds[l],
            p, H)
    assert torch.equal(out, xr)


# ---------------------------------------------------------------------------
# the path choice and its refusals, through a stand-in library


class _Reached(Exception):
    pass


class _Lib:
    """A stand-in library whose kernel-3 path query answers `path`; any
    other entry reached raises _Reached (the wrapper got past its checks)."""

    def __init__(self, path):
        self.path = path

    def mmtx_encoder_train_fwd_path(self, dtype, D, h, F_):
        return self.path

    def __getattr__(self, name):
        raise _Reached(name)


def _stack_args(dtype=BF16, D=256, T=5, offset=None):
    params = [t.detach().to(dtype) for layer in Encoder(D, F, 1).layers
              for t in et._layer_tensors(layer)]
    x = torch.zeros(2, T, D, dtype=dtype)
    if offset == "param":  # q's weight one element off a 16-byte boundary
        params[2] = torch.zeros(D * D + 1, dtype=dtype)[1:].view(D, D)
    if offset == "x":
        x = torch.zeros(x.numel() + 1, dtype=dtype)[1:].view(x.shape)
    return params, x, torch.ones(2, T), torch.zeros(1, 4, dtype=torch.int64)


def _call(monkeypatch, lib_path, **kw):
    monkeypatch.setattr(et, "use_kernel", lambda t: True)
    monkeypatch.setattr(_build, "load", lambda *a, **k: _Lib(lib_path))
    params, x, km, seeds = _stack_args(**kw)
    et.encoder_stack_train_fwd(params, x, km, seeds, 0.1, H)


@pytest.mark.parametrize("dtype,D,lib_path,want", [
    (BF16, 256, 0, 1), (BF16, 128, 0, 1), (torch.float32, 256, 1, 0),
    (BF16, 16, 1, 0)])
def test_wrapper_raises_when_the_library_takes_another_path(
        monkeypatch, dtype, D, lib_path, want):
    assert enc_k.kernel_path(dtype, D // H, D, F) == want
    with pytest.raises(RuntimeError, match=f"not kernel_path's {want}"):
        _call(monkeypatch, lib_path, dtype=dtype, D=D)


@pytest.mark.parametrize("dtype,D,path", [
    (BF16, 256, 1), (BF16, 128, 1), (torch.float32, 256, 0), (BF16, 16, 0)])
def test_wrapper_passes_its_checks_where_the_paths_agree(monkeypatch, dtype, D,
                                                         path):
    with pytest.raises(_Reached, match="mmtx_encoder_train_workspace"):
        _call(monkeypatch, path, dtype=dtype, D=D)


@pytest.mark.parametrize("offset", ["param", "x"])
def test_wgmma_path_refuses_what_is_not_16_byte_aligned(monkeypatch, offset):
    with pytest.raises(ValueError, match="16-byte aligned"):
        _call(monkeypatch, 1, offset=offset)
    with pytest.raises(_Reached):  # the FMA path takes it
        _call(monkeypatch, 0, dtype=torch.float32, offset=offset)


# ---------------------------------------------------------------------------
# the build's spill report for the training chain, which chip_smoke.py gates

def _ptxas_entry(symbol: str, stores: int) -> str:
    return (f"ptxas info    : Compiling entry function '{symbol}' for "
            f"'sm_90a'\nptxas info    : Function properties for {symbol}\n"
            f"    0 bytes stack frame, {stores} bytes spill stores, {stores} "
            "bytes spill loads\nptxas info    : Used 251 registers\n")


def test_spill_gate_reads_the_training_chains_by_their_symbols():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    # the symbols ptxas reports for chain_kernel<D, 128, kTrain, kH4>
    chain = ("_ZN4mmtx9enc_wgmma12chain_kernelILi{}ELi128ELb{}ELb{}EEEvNS0_9"
             "ChainArgsE")
    train = [_ptxas_entry(chain.format(D, 1, h), 0) for D in (128, 256)
             for h in (0, 1)]
    evals = [_ptxas_entry(chain.format(D, 0, 0), 0) for D in (128, 256)]
    gate = lambda log: cs.spill_gate(log, cs.ENC_WGMMA,
                                     cs.ENC_TRAIN_FWD_CHAINS)
    assert gate("".join(evals + train)) == 0
    assert gate("".join(evals + train[:3] + [
        _ptxas_entry(chain.format(256, 1, 1), 4)])) == 8
    with pytest.raises(cs.SmokeFailure, match="cannot check"):
        gate("".join(evals))
    with pytest.raises(cs.SmokeFailure, match="cannot check"):
        gate("".join(evals + train[::2]))  # no hash4 instance
