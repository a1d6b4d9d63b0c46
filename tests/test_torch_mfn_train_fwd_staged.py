"""Kernel 6's three stages (kernel B's, csrc/mfn.cu, in their training
instantiations) in PyTorch on the CPU: `mfn_train_fwd_staged_plain`, the
LSTM scan, the feed-forward part batched over all B*T rows and the memory
scan with the gamma-hidden dropout, in the kernel's order, held against the
JAX package's `_fwd_call` (Pallas, interpret mode) in float32 (atol 2e-5, as
tests/test_torch_train_kernels.py) and against the port's step-by-step
`mfn_train_fwd_plain` in float64 (within 1e-12: the two differ only in the
order of float64 sums), on hs, cs and mems.  Inputs of width 12 made with
numpy from a seed, JAX parameters copied into the port's MFN; modality sets
A+V+L, L alone and emotient+acoustic (H = 16, the narrowest), gamma dropout
0.2 and 0, and the edges T = 1 and B = 1.  In bf16, hs, cs and mems are the
float32 recurrence's values rounded once; at p = 0, hs and mems are kernel
B's stages' bits.  Also the wrapper's guard: kernel 6 refuses, with the
widths, an MFN whose W_hh cannot sit in one block's shared memory."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_transformer_tpu.ops import mfn_core as jmfn
from multimodal_transformer_tpu.ops.pallas.mfn_train import _fwd_call
from multimodal_transformer_tpu_torch.ops import mfn_core
from multimodal_transformer_tpu_torch.ops.cuda import mfn as mfn_k
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
    """JAX parameters, the port's MFN holding them, numpy inputs and a
    [t, 2] table of uint32 seeds (int64)."""
    dims = {m: DIM for m in mods}
    params = jax.tree_util.tree_map(
        np.asarray, jmfn.mfn_init(jax.random.PRNGKey(3), mods, dims, 1))
    mfn = load_jax_params(mfn_core.MFN(mods, dims, 1), params)
    rs = np.random.RandomState(5)
    inputs = {m: rs.randn(b, t, DIM).astype(np.float32) for m in mods}
    seeds = rs.randint(0, 2 ** 32, (t, 2), dtype=np.uint64).astype(np.int64)
    return params, mfn, inputs, seeds


def _args(mfn, inputs, dtype=torch.float32):
    """Kernel 6's tensor arguments: the inputs' hoisted projections, W_hh
    and the gate tensors."""
    mfn = mfn.to(dtype)
    with torch.no_grad():
        xps = [x.contiguous() for x in mfn_core.hoisted_inputs(
            mfn, {m: torch.from_numpy(v).to(dtype) for m, v in inputs.items()})]
    whhs = [getattr(mfn, f"lstm_{m}").weight_hh.detach() for m in mfn.mods]
    gates = [g.detach() for g in mfn.gate_tensors()]
    return xps, whhs, gates


def _check_against_pallas(mods, p, b=B, t=T):
    params, mfn, inputs, seeds = _case(mods, b, t)
    xps, whhs, gates = _args(mfn, inputs)
    gp = {f"whh_{m}": params[f"lstm_{m}"]["weight_hh"] for m in mods}
    gp.update({n: params[n] for n in GATE_NAMES})
    jxps = {m: jnp.asarray(x.numpy().transpose(1, 0, 2))
            for m, x in zip(mods, xps)}
    jseeds = jnp.asarray(seeds.astype(np.uint32).view(np.int32))
    want = _fwd_call(gp, jxps, jseeds, mods, p, p, interpret=True)
    got = mfnt.mfn_train_fwd_staged_plain(xps, whhs, gates, seeds, (p, p))
    for name, g, w in zip(("hs", "cs", "mems"), got, want):
        w = np.asarray(w).transpose(1, 0, 2)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, atol=MFN_ATOL, err_msg=name)


def _check_against_step_plain_float64(mods, p, b=B, t=T):
    _, mfn, inputs, seeds = _case(mods, b, t)
    args = (*_args(mfn, inputs, torch.float64), seeds, (p, p))
    got = mfnt.mfn_train_fwd_staged_plain(*args)
    want = mfnt.mfn_train_fwd_plain(*args)
    for g, w in zip(got, want):
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
    """T = 1 (a single step from zero states) and B = 1, against the Pallas
    kernel in float32 and the step-by-step forward in float64."""
    mods = MOD_SETS["AVL"]
    _check_against_pallas(mods, 0.2, b, t)
    _check_against_step_plain_float64(mods, 0.2, b, t)


@pytest.mark.parametrize("p", [0.2, 0.0])
def test_staged_plain_bf16_rounds_once(p):
    """bf16 storage: every output, cs included, is the float32 recurrence
    (on the same bf16 inputs and weights) rounded to bf16 once."""
    _, mfn, inputs, seeds = _case(MOD_SETS["AVL"])
    xps, whhs, gates = _args(mfn, inputs, torch.bfloat16)
    got = mfnt.mfn_train_fwd_staged_plain(xps, whhs, gates, seeds, (p, p))
    f32 = mfnt.mfn_train_fwd_staged_plain(
        *([t.float() for t in ts] for ts in (xps, whhs, gates)), seeds,
        (p, p))
    for name, g, w in zip(("hs", "cs", "mems"), got, f32):
        assert g.dtype == torch.bfloat16, name
        assert torch.equal(g, w.to(torch.bfloat16)), name


def test_staged_plain_at_p0_is_kernel_b():
    """Without dropout kernel 6's stages are kernel B's: hs and mems are the
    same bits, and cs is the LSTM scan's c_t."""
    _, mfn, inputs, seeds = _case(MOD_SETS["EA"])
    xps, whhs, gates = _args(mfn, inputs)
    hs, cs, mems = mfnt.mfn_train_fwd_staged_plain(xps, whhs, gates, seeds,
                                                   (0.0, 0.0))
    want_hs, want_mems = mfn_k.mfn_scan_staged_plain(xps, whhs, gates)
    assert torch.equal(hs, want_hs) and torch.equal(mems, want_mems)
    assert torch.equal(cs, mfn_k.staged_plain(xps, whhs, gates)[1])


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
    seeds = np.zeros((5, 2), dtype=np.int64)
    xps, whhs, gates = _args(mfn, inputs, dtype)
    monkeypatch.setattr(mfnt, "use_kernel", lambda t: True)
    with pytest.raises(ValueError, match=rf"hidden widths \[{H}\]"):
        mfnt.mfn_train_fwd(xps, whhs, gates, seeds, (0.2, 0.2))
