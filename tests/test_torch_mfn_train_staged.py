"""Kernel 7's five stages (csrc/mfn_train.cu) in PyTorch on the CPU:
`mfn_train_bwd_staged_plain`, the recompute of every step at once, the
memory's reverse scan, the rest of the VJP over all rows, the LSTM's reverse
scan and the parameter gradients in the kernel's order, held against the
JAX package's `mfn_states_fused_train` VJP (its Pallas `_bwd_call` in
interpret mode) in float32 (atol 2e-5, as tests/test_torch_train_kernels.py)
and against the port's step-by-step `mfn_train_bwd_plain` in float64 (within
1e-12: the two differ only in the order of float64 sums).  Inputs of width
12 and cotangents made with numpy from a seed, JAX parameters copied into
the port's MFN; modality sets A+V+L, L alone and emotient+acoustic (H = 16,
the narrowest), gamma dropout 0.2 and 0, and the edges B = 1 and T = 1.
Also the wrapper's guard: kernel 7's stages refuse, with the widths, an MFN
whose W_hh cannot sit in one block's shared memory."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_transformer_tpu.ops import mfn_core as jmfn
from multimodal_transformer_tpu.ops.pallas.mfn_train import \
    mfn_states_fused_train
from multimodal_transformer_tpu_torch.ops import mfn_core
from multimodal_transformer_tpu_torch.ops.cuda import mfn_train as mfnt
from multimodal_transformer_tpu_torch.utils import prng
from multimodal_transformer_tpu_torch.utils.params import load_jax_params
from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401


MOD_SETS = {"AVL": ("acoustic", "image", "linguistic"),
            "L": ("linguistic",),
            "EA": ("emotient", "acoustic")}
DIM = 12
B, T = 3, 9
MFN_ATOL = 2e-5
F64_TOL = 1e-12
GATE_NAMES = ("att1_fc1", "att1_fc2", "att2_fc1", "att2_fc2", "gamma1_fc1",
              "gamma1_fc2", "gamma2_fc1", "gamma2_fc2")


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _case(mods, b=B, t=T):
    """JAX parameters, the port's MFN holding them, numpy inputs, cotangents
    and a [t, 2] table of uint32 seeds (int64)."""
    dims = {m: DIM for m in mods}
    params = jax.tree_util.tree_map(
        np.asarray, jmfn.mfn_init(jax.random.PRNGKey(3), mods, dims, 1))
    mfn = load_jax_params(mfn_core.MFN(mods, dims, 1), params)
    rs = np.random.RandomState(5)
    inputs = {m: rs.randn(b, t, DIM).astype(np.float32) for m in mods}
    th = sum(mfn_core.HIDDEN_DIM[m] for m in mods)
    g_hs = rs.randn(b, t, th).astype(np.float32)
    g_mems = rs.randn(b, t, mfn_core.MEM_DIM).astype(np.float32)
    seeds = rs.randint(0, 2 ** 32, (t, 2), dtype=np.uint64).astype(np.int64)
    return params, mfn, inputs, g_hs, g_mems, seeds


def _args(mfn, inputs, g_hs, g_mems, seeds, p, dtype=torch.float32):
    """Kernel 7's arguments: the inputs' hoisted projections, W_hh, the gate
    tensors, seeds, rates, kernel 6's saved states and the cotangents."""
    mfn = mfn.to(dtype)
    with torch.no_grad():
        xps = [x.contiguous() for x in mfn_core.hoisted_inputs(
            mfn, {m: torch.from_numpy(v).to(dtype) for m, v in inputs.items()})]
    whhs = [getattr(mfn, f"lstm_{m}").weight_hh.detach() for m in mfn.mods]
    gates = [g.detach() for g in mfn.gate_tensors()]
    ps = (p, p)
    hs, cs, mems = mfnt.mfn_train_fwd_plain(xps, whhs, gates, seeds, ps)
    return (xps, whhs, gates, seeds, ps, hs, cs, mems,
            torch.from_numpy(g_hs).to(dtype), torch.from_numpy(g_mems).to(dtype))


def _pallas_vjp(params, xps, g_hs, g_mems, seeds, mods, p):
    """(d_xps per modality [B, T, 4H], the parameter grads) of the Pallas
    kernels' custom VJP on the port's hoisted input projections."""
    gp = {f"whh_{m}": params[f"lstm_{m}"]["weight_hh"] for m in mods}
    gp.update({n: params[n] for n in GATE_NAMES})
    jxps = {m: jnp.asarray(x.numpy().transpose(1, 0, 2))
            for m, x in zip(mods, xps)}
    jseeds = jnp.asarray(seeds.astype(np.uint32).view(np.int32))

    def f(gp_, xps_):
        return mfn_states_fused_train(gp_, xps_, jseeds, mods, (p, p))

    _, vjp = jax.vjp(f, gp, jxps)
    d_gp, d_xps = vjp((jnp.asarray(g_hs.transpose(1, 0, 2)),
                       jnp.asarray(g_mems.transpose(1, 0, 2))))
    return ({m: np.asarray(d_xps[m]).transpose(1, 0, 2) for m in mods},
            d_gp)


def _check_against_pallas(mods, p, b=B, t=T):
    params, mfn, inputs, g_hs, g_mems, seeds = _case(mods, b, t)
    args = _args(mfn, inputs, g_hs, g_mems, seeds, p)
    want_dxps, want_gp = _pallas_vjp(params, args[0], g_hs, g_mems, seeds,
                                     mods, p)
    d_xps, d_whhs, d_gates = mfnt.mfn_train_bwd_staged_plain(*args)
    for m, dx, dw in zip(mods, d_xps, d_whhs):
        assert dx.shape == want_dxps[m].shape
        np.testing.assert_allclose(dx.numpy(), want_dxps[m], atol=MFN_ATOL,
                                   err_msg=m)
        np.testing.assert_allclose(dw.numpy(), np.asarray(want_gp[f"whh_{m}"]),
                                   atol=MFN_ATOL, err_msg=m)
    for i, name in enumerate(GATE_NAMES):
        for k, got in zip(("weight", "bias"), d_gates[2 * i:2 * i + 2]):
            np.testing.assert_allclose(got.numpy(),
                                       np.asarray(want_gp[name][k]),
                                       atol=MFN_ATOL, err_msg=f"{name}.{k}")


def _check_against_step_plain_float64(mods, p, b=B, t=T):
    _, mfn, inputs, g_hs, g_mems, seeds = _case(mods, b, t)
    args = _args(mfn, inputs, g_hs, g_mems, seeds, p, torch.float64)
    got = mfnt.mfn_train_bwd_staged_plain(*args)
    want = mfnt.mfn_train_bwd_plain(*args)
    for gs, ws in zip(got, want):
        assert len(gs) == len(ws)
        for g, w in zip(gs, ws):
            assert g.dtype == torch.float64 and g.shape == w.shape
            assert (g - w).abs().max().item() <= F64_TOL


@pytest.mark.parametrize("p", [0.2, 0.0])
@pytest.mark.parametrize("mods", sorted(MOD_SETS))
def test_staged_plain_matches_pallas_interpret(mods, p):
    _check_against_pallas(MOD_SETS[mods], p)


@pytest.mark.parametrize("p", [0.2, 0.0])
@pytest.mark.parametrize("mods", sorted(MOD_SETS))
def test_staged_plain_matches_step_plain_float64(mods, p):
    _check_against_step_plain_float64(MOD_SETS[mods], p)


@pytest.mark.parametrize("b,t", [(3, 1), (1, 9), (1, 1)])
def test_staged_plain_edges(b, t):
    """T = 1 (a single step from zero states, no carry) and B = 1, against
    the Pallas kernel in float32 and the step-by-step backward in float64."""
    mods = MOD_SETS["AVL"]
    _check_against_pallas(mods, 0.2, b, t)
    _check_against_step_plain_float64(mods, 0.2, b, t)


@pytest.mark.parametrize("dtype,H", [(torch.float32, 128),
                                     (torch.bfloat16, 176)])
def test_wrapper_raises_when_w_hh_cannot_fit(monkeypatch, dtype, H):
    """W_hh of H = 128 takes 256 KB in fp32, H = 176 242 KB in bf16: past a
    block's 227 KB.  The wrapper raises before building anything (here,
    without nvcc, a build would raise another error)."""
    monkeypatch.setitem(mfn_core.HIDDEN_DIM, "linguistic", H)
    mfn = load_jax_params(
        mfn_core.MFN(("linguistic",), {"linguistic": DIM}, 1),
        mfn_core.mfn_init(prng.key(0), ("linguistic",), {"linguistic": DIM},
                          1))
    rs = np.random.RandomState(5)
    inputs = {"linguistic": rs.randn(2, 5, DIM).astype(np.float32)}
    g_hs = rs.randn(2, 5, H).astype(np.float32)
    g_mems = rs.randn(2, 5, mfn_core.MEM_DIM).astype(np.float32)
    seeds = np.zeros((5, 2), dtype=np.int64)
    args = _args(mfn, inputs, g_hs, g_mems, seeds, 0.2, dtype)
    monkeypatch.setattr(mfnt, "use_kernel", lambda t: True)
    with pytest.raises(ValueError, match=rf"hidden widths \[{H}\]"):
        mfnt.mfn_train_bwd(*args)


def test_every_configuration_fits_the_stages():
    """Kernel 7's scans fit one block for every modality set of the MFT and
    B3-MFN (any non-empty subset of the four), fp32 and bf16, at the widest
    batch of a long-video bucket."""
    names = sorted(mfn_core.HIDDEN_DIM)
    widths = (mfn_core.MEM_DIM, mfn_core.H_GAMMA1, mfn_core.H_GAMMA2)
    for n in range(1, 2 ** len(names)):
        hid = [mfn_core.HIDDEN_DIM[m] for i, m in enumerate(names)
               if n >> i & 1]
        for itemsize in (4, 2):
            mfnt.check_bwd_fit(hid, *widths, itemsize, 32, 1120, "test")
