"""Port parity: the MFN recurrence and its output head, float32 on the CPU,
atol 1e-5.  A+V+L with input width 16, B=3, T=11.  The port's plain
recurrence (the kernel's CPU path) and head are held against the JAX
package's `mfn_scan(rng=None)` and `mfn_scan_pallas(interpret=True)`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_transformer_tpu.ops import mfn_core as jmfn
from multimodal_transformer_tpu.ops.pallas.mfn_kernel import mfn_scan_pallas
from multimodal_transformer_tpu_torch.ops import mfn_core
from multimodal_transformer_tpu_torch.ops.cuda import mfn as mfn_k
from multimodal_transformer_tpu_torch.utils.params import load_jax_params
from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401


MODS = ("acoustic", "image", "linguistic")
DIMS = {m: 16 for m in MODS}
B, T = 3, 11
ATOL = 1e-5


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(scope="module")
def case():
    params = jax.tree_util.tree_map(
        np.asarray, jmfn.mfn_init(jax.random.PRNGKey(3), MODS, DIMS, 1))
    rs = np.random.RandomState(5)
    inputs = {m: rs.randn(B, T, DIMS[m]).astype(np.float32) for m in MODS}
    mfn = load_jax_params(mfn_core.MFN(MODS, DIMS, 1), params).eval()
    t_inputs = {m: torch.from_numpy(v) for m, v in inputs.items()}
    return params, inputs, mfn, t_inputs


def test_mfn_scan_matches_jnp(case):
    params, inputs, mfn, t_inputs = case
    want = jmfn.mfn_scan(params, {m: jnp.asarray(v) for m, v in inputs.items()},
                         MODS, rng=None)
    with torch.no_grad():
        got = mfn_core.mfn_scan(mfn, t_inputs)
    assert got.shape == (B, T, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_mfn_states_match_pallas_interpret(case):
    params, inputs, mfn, t_inputs = case
    want_hs, want_mems = mfn_scan_pallas(
        params, {m: jnp.asarray(v) for m, v in inputs.items()}, list(MODS),
        interpret=True)
    with torch.no_grad():
        hs, mems = mfn_core.mfn_states(mfn, t_inputs)
    np.testing.assert_allclose(hs.numpy(), np.asarray(want_hs), atol=ATOL)
    np.testing.assert_allclose(mems.numpy(), np.asarray(want_mems), atol=ATOL)


def test_kernel_wrapper_cpu_path_is_the_plain_version(case):
    _, _, mfn, t_inputs = case
    with torch.no_grad():
        xps = mfn_core.hoisted_inputs(mfn, t_inputs)
        whhs = [getattr(mfn, f"lstm_{m}").weight_hh for m in MODS]
        a = mfn_k.mfn_scan_fused(xps, whhs, mfn.gate_tensors())
        b = mfn_k.mfn_scan_fused_plain(xps, whhs, mfn.gate_tensors())
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_kernel_shape_checks(case):
    _, _, mfn, t_inputs = case
    with torch.no_grad():
        xps = mfn_core.hoisted_inputs(mfn, t_inputs)
    whhs = [getattr(mfn, f"lstm_{m}").weight_hh for m in MODS]
    gates = mfn.gate_tensors()
    mfn_k._check_shapes(xps, whhs, gates)
    with pytest.raises(ValueError):
        mfn_k._check_shapes(xps, whhs[:2], gates)
    with pytest.raises(ValueError):
        mfn_k._check_shapes(xps, whhs, gates[:15])
    with pytest.raises(ValueError):
        mfn_k._check_shapes([x[:, :5] for x in xps[:1]] + xps[1:], whhs, gates)
    odd = mfn_core.MFN(MODS, DIMS, 1)
    odd.att1_fc1 = torch.nn.Linear(odd.att1_fc1.in_features, 127)
    odd.att1_fc2 = torch.nn.Linear(127, odd.att1_fc2.out_features)
    with pytest.raises(ValueError, match="even"):
        mfn_k._check_shapes(xps, whhs, odd.gate_tensors())


def test_kernel_shared_memory_fits_every_mft_modality_set():
    """Kernel B's serial stages fit one block for every modality set of the
    MFT and B3-MFN (any non-empty subset of the four), fp32 and bf16, at the
    widest batch of a long-video bucket."""
    names = sorted(mfn_core.HIDDEN_DIM)
    widths = (mfn_core.MEM_DIM, mfn_core.H_GAMMA1, mfn_core.H_GAMMA2)
    for n in range(1, 2 ** len(names)):
        hid = [mfn_core.HIDDEN_DIM[m] for i, m in enumerate(names)
               if n >> i & 1]
        for itemsize in (4, 2):
            need = mfn_k.staged_smem_bytes(hid, *widths, itemsize)
            assert max(need.values()) <= mfn_k.SMEM_OPT_IN
            mfn_k.check_staged_fit(hid, *widths, itemsize, 32, 1120, "test")
