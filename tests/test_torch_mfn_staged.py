"""Kernel B's three stages (csrc/mfn.cu) in PyTorch on the CPU:
`mfn_scan_staged_plain`, the LSTM scan, the feed-forward part batched over
all B*T rows and the memory scan in the kernel's order, held against the
JAX package's `mfn_scan_pallas(interpret=True)` in float32 (atol 1e-5, as
tests/test_torch_mfn.py) and against the port's step-by-step
`mfn_scan_fused_plain` in float64 (within 1e-12: the two differ only in the
order of float64 sums).  Inputs of width 16 made with numpy from a seed, JAX
parameters copied into the port's MFN; modality sets A+V+L, L alone and
emotient+acoustic (H = 16, the narrowest).  Also the wrapper's guard: kernel
B's stages refuse, with the widths, an MFN whose W_hh cannot sit in one
block's shared memory."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_transformer_tpu.ops import mfn_core as jmfn
from multimodal_transformer_tpu.ops.pallas.mfn_kernel import mfn_scan_pallas
from multimodal_transformer_tpu_torch.ops import mfn_core
from multimodal_transformer_tpu_torch.ops.cuda import mfn as mfn_k
from multimodal_transformer_tpu_torch.utils import prng
from multimodal_transformer_tpu_torch.utils.params import load_jax_params
from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401


MOD_SETS = {"AVL": ("acoustic", "image", "linguistic"),
            "L": ("linguistic",),
            "EA": ("emotient", "acoustic")}
DIM = 16
B, T = 3, 11
ATOL = 1e-5
F64_TOL = 1e-12


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _case(mods, b=B, t=T):
    dims = {m: DIM for m in mods}
    params = jax.tree_util.tree_map(
        np.asarray, jmfn.mfn_init(jax.random.PRNGKey(3), mods, dims, 1))
    rs = np.random.RandomState(5)
    inputs = {m: rs.randn(b, t, DIM).astype(np.float32) for m in mods}
    mfn = load_jax_params(mfn_core.MFN(mods, dims, 1), params).eval()
    return params, inputs, mfn


def _scan_args(mfn, inputs, dtype=torch.float32):
    mfn = mfn.to(dtype)
    with torch.no_grad():
        xps = mfn_core.hoisted_inputs(
            mfn, {m: torch.from_numpy(v).to(dtype) for m, v in inputs.items()})
    whhs = [getattr(mfn, f"lstm_{m}").weight_hh.detach() for m in mfn.mods]
    return xps, whhs, [g.detach() for g in mfn.gate_tensors()]


def _pallas(params, inputs, mods):
    return mfn_scan_pallas(params, {m: jnp.asarray(v) for m, v in
                                    inputs.items()}, list(mods),
                           interpret=True)


@pytest.mark.parametrize("mods", sorted(MOD_SETS))
def test_staged_plain_matches_pallas_interpret(mods):
    params, inputs, mfn = _case(MOD_SETS[mods])
    want = _pallas(params, inputs, MOD_SETS[mods])
    got = mfn_k.mfn_scan_staged_plain(*_scan_args(mfn, inputs))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


@pytest.mark.parametrize("mods", sorted(MOD_SETS))
def test_staged_plain_matches_fused_plain_float64(mods):
    _, inputs, mfn = _case(MOD_SETS[mods])
    args = _scan_args(mfn, inputs, torch.float64)
    got = mfn_k.mfn_scan_staged_plain(*args)
    want = mfn_k.mfn_scan_fused_plain(*args)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        assert (g - w).abs().max().item() <= F64_TOL


@pytest.mark.parametrize("b,t", [(3, 1), (1, 11), (1, 1)])
def test_staged_plain_edges(b, t):
    """T = 1 (the first step's c* holds c_{-1} = 0) and B = 1, against the
    Pallas kernel in float32 and the step-by-step recurrence in float64."""
    mods = MOD_SETS["AVL"]
    params, inputs, mfn = _case(mods, b, t)
    got = mfn_k.mfn_scan_staged_plain(*_scan_args(mfn, inputs))
    for g, w in zip(got, _pallas(params, inputs, mods)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
    args = _scan_args(mfn, inputs, torch.float64)
    for g, w in zip(mfn_k.mfn_scan_staged_plain(*args),
                    mfn_k.mfn_scan_fused_plain(*args)):
        assert (g - w).abs().max().item() <= F64_TOL


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
                          1)).to(dtype)
    inputs = {"linguistic": np.random.RandomState(5).randn(2, 5, DIM)
              .astype(np.float32)}
    args = _scan_args(mfn, inputs, dtype)
    monkeypatch.setattr(mfn_k, "use_kernel", lambda t: True)
    with torch.no_grad(), pytest.raises(ValueError,
                                        match=rf"hidden widths \[{H}\]"):
        mfn_k.mfn_scan_fused(*args)
