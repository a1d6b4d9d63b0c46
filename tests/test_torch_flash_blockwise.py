"""Kernel 11's TMA + wgmma path (bf16, d_k in {16, 32}), its arithmetic
emulated block by block on the CPU, and the wrapper's choice of path.

The CUDA kernel cannot run here, so `_blockwise` repeats its arithmetic in
torch: q' rounded to bf16, 128-key tiles, exact products summed in float32,
-1e9 for masked keys and -inf past Tk, a running max from -1e9 and a running
sum in float32, exp2 of (s - m) * log2(e), p split into bf16 hi + lo with
both products accumulated in float32, and the division at the end.  It is
held to the competitive bound err <= 2 * err(competitor - fp64) + 1e-6
against two competitors:
  * `flash_attention_masked_plain` in bf16 (the kernel's CPU path); both
    are measured against the plain version in float64 on the same bf16
    inputs, as `verify.check_flash_attention` does on the card;
  * the Pallas `flash_attention_masked` in interpret mode with 128-row
    blocks (as tests/test_torch_flash.py runs it).  On the CPU, XLA keeps
    q * scale in float32 up to the dot (tests/test_torch_flash.py), where
    the port rounds q' to bf16 as the TPU's matrix unit does: a different
    function by up to 2^-9 of each score.  So each is measured against the
    float64 of its own function: the Pallas kernel against the plain
    version in float64, the emulation against the same with q' rounded to
    bf16 first (`_dense64`).  Rows of a video with no key are left out of
    this comparison when T is not a multiple of the block: the Pallas
    kernel pads the keys to its block and averages v over the padded
    length, where the port averages over the T keys.

Cases: ragged T (601, 137, 200: key tiles cut short, query tiles past Tq),
videos with no key and videos of one key.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_transformer_tpu.ops.pallas import attention as pattn
from multimodal_transformer_tpu_torch.ops.cuda import flash_attention as fa_k
from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401


H = 2
TILE = 128
LOG2E = 1.4426950408889634


def _blockwise(q, k, v, kmask, h):
    """The TMA + wgmma kernel's arithmetic on bf16 q, k, v [BH, T, d_k]."""
    BH, Tq, d_k = q.shape
    Tk = k.shape[1]
    qs = (q.float() * fa_k.q_scale(d_k, torch.bfloat16)).to(torch.bfloat16)
    keep = kmask.repeat_interleave(h, dim=0) != 0
    m = torch.full((BH, Tq, 1), fa_k.NEG_INF)
    l = torch.zeros(BH, Tq, 1)
    o = torch.zeros(BH, Tq, d_k)
    for k0 in range(0, Tk, TILE):
        kt = torch.zeros(BH, TILE, d_k)
        vt = torch.zeros(BH, TILE, d_k)
        n = min(TILE, Tk - k0)
        kt[:, :n] = k[:, k0:k0 + n].float()
        vt[:, :n] = v[:, k0:k0 + n].float()
        s = qs.float() @ kt.transpose(1, 2)
        kept = torch.zeros(BH, TILE, dtype=torch.bool)
        kept[:, :n] = keep[:, k0:k0 + n]
        s = s.masked_fill(~kept[:, None, :], fa_k.NEG_INF)
        s[..., n:] = -torch.inf
        mn = torch.maximum(m, s.amax(-1, keepdim=True))
        a = torch.exp2((m - mn) * LOG2E)
        p = torch.exp2((s - mn) * LOG2E)
        hi = p.to(torch.bfloat16).float()
        lo = (p - hi).to(torch.bfloat16).float()
        l = l * a + p.sum(-1, keepdim=True)
        o = o * a + hi @ vt + lo @ vt
        m = mn
    return (o / l).to(torch.bfloat16)


def _dense64(q, k, v, kmask, h):
    """The port's function in float64 after q' is rounded to bf16."""
    BH, Tq, d_k = q.shape
    qs = (q.float() * fa_k.q_scale(d_k, torch.bfloat16)).to(torch.bfloat16)
    s = qs.double() @ k.double().transpose(1, 2)
    keys = kmask.repeat_interleave(h, dim=0)[:, None, :] == 0
    return torch.softmax(s.masked_fill(keys, fa_k.NEG_INF), -1) @ v.double()


def _case(seed, T, d_k, lens):
    rs = np.random.RandomState(seed)
    q, k, v = (torch.from_numpy(rs.randn(len(lens) * H, T, d_k)
                                .astype(np.float32)).to(torch.bfloat16)
               for _ in range(3))
    kmask = torch.zeros(len(lens), T)
    for b, n in enumerate(lens):
        kmask[b, :n] = 1.0
    return q, k, v, kmask


def _pallas(q, k, v, kmask):
    j = lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16)
    out = pattn.flash_attention_masked(
        j(q), j(k), j(v), jnp.asarray(np.repeat(kmask.numpy(), H, axis=0)),
        blk_q=TILE, blk_k=TILE, interpret=True)
    return torch.from_numpy(np.asarray(out.astype(jnp.float32)))


def _err(a, ref, rows):
    return (a.double() - ref)[rows].abs().max().item()


CASES = {"T601": (601, [601, 300, 0]), "T137": (137, [137, 0, 1]),
         "T200": (200, [129, 200, 64])}


@pytest.mark.parametrize("d_k", [16, 32])
@pytest.mark.parametrize("case", sorted(CASES))
def test_blockwise_emulation_within_bound_of_plain_and_pallas(case, d_k):
    T, lens = CASES[case]
    q, k, v, kmask = _case(len(lens) * T + d_k, T, d_k, lens)
    ref = fa_k.flash_attention_masked_plain(q.double(), k.double(),
                                            v.double(), kmask, H)
    got = _blockwise(q, k, v, kmask, H)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
    every = torch.ones(q.shape[0], dtype=torch.bool)
    plain = fa_k.flash_attention_masked_plain(q, k, v, kmask, H)
    err, plain_err = _err(got, ref, every), _err(plain, ref, every)
    assert err <= 2 * plain_err + 1e-6, (err, plain_err)
    rows = torch.from_numpy(np.repeat(
        (kmask.sum(1) > 0).numpy() | (T % TILE == 0), H))
    pallas = _pallas(q, k, v, kmask)
    err = _err(got, _dense64(q, k, v, kmask, H), rows)
    pallas_err = _err(pallas, ref, rows)
    assert err <= 2 * pallas_err + 1e-6, (err, pallas_err)


def test_blockwise_emulation_of_a_video_with_no_key_is_the_mean_of_v():
    q, k, v, kmask = _case(9, 601, 32, [0, 5])
    got = _blockwise(q, k, v, kmask, H)[:H].double()
    want = v[:H].double().mean(dim=1, keepdim=True).expand_as(got)
    # the uniform p = 1 is exact, so only the output's rounding remains
    assert (got - want).abs().max().item() <= \
        2.0 ** -8 * want.abs().max().item()


@pytest.mark.parametrize("d_k", fa_k.SUPPORTED_DK)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_path_of_dtype_and_d_k(dtype, d_k):
    path = fa_k.kernel_path(getattr(torch, dtype), d_k)
    if dtype == "float32":
        assert path == fa_k.PATH_FMA
    else:
        assert path == (fa_k.PATH_WGMMA if d_k >= 16 else fa_k.PATH_MMA)


@pytest.mark.parametrize("dtype,d_k,error", [
    (torch.bfloat16, 12, ValueError), (torch.float32, 64, ValueError),
    (torch.float16, 32, TypeError), (torch.float64, 16, TypeError)])
def test_kernel_path_refuses_what_no_path_takes(dtype, d_k, error):
    with pytest.raises(error):
        fa_k.kernel_path(dtype, d_k)
