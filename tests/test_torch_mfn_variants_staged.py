"""Rows 8 and 9 (ops/cuda/mfn_variants.py) as launches of kernel B's three
stages on views of their packed and padded tensors, on the CPU:

- each layout's views (`packed_views`, `aligned_views`), applied with
  torch.as_strided to the packed or padded buffers, are the original
  weights exactly (the aligned ones at their real lanes, zero or -1e9 on
  the pad lanes), for 2-4 modalities with the emotient one (H = 16), at hp
  32 and 128; and the C entries' arguments made from them;
- the packed views through the stages in PyTorch (`staged_views_plain`)
  give kernel B's `staged_plain` bit for bit, in float32 and float64;
- the aligned views through the stages (K = 2 sum(HP_m)) match the JAX
  package's `mfn_scan_pallas_aligned(interpret=True)` (rtol 1e-5, atol
  1e-6, the tolerance of tests/test_pallas_kernels.py) and the port's
  step-by-step `mfn_scan_aligned_plain` in float64 (within 1e-12: the two
  differ only in the order of float64 sums);
- every modality set of the MFT fits the stages in the aligned layout;
- chip_smoke.py's spill gate reads every instantiation of the stages.
Inputs made with numpy from a seed; against the Pallas kernel, JAX
parameters copied into the port's MFN, elsewhere the port's seeded init."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_transformer_tpu.ops import mfn_core as jmfn
from multimodal_transformer_tpu.ops.pallas import mfn_kernel as pk
from multimodal_transformer_tpu_torch.ops import mfn_core
from multimodal_transformer_tpu_torch.ops.cuda import mfn as mfn_k
from multimodal_transformer_tpu_torch.ops.cuda import mfn_variants as mv
from multimodal_transformer_tpu_torch.utils import prng
from multimodal_transformer_tpu_torch.utils.params import load_jax_params
from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401


MOD_SETS = {"AVL": ("acoustic", "image", "linguistic"),
            "EA": ("emotient", "acoustic"),
            "LEAV": ("linguistic", "emotient", "acoustic", "image")}
HPS = (mv.ALIGN_HP, 128)
DIM = 8
RTOL, ATOL = 1e-5, 1e-6
F64_TOL = 1e-12


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _inputs(mods, B, T, seed, dims):
    rs = np.random.RandomState(seed)
    return {m: rs.randn(B, T, dims[m]).astype(np.float32) for m in mods}


def _case(mods, B=2, T=3, seed=7):
    """Numpy inputs and a seeded MFN of the port (the port against itself:
    no JAX parameters needed)."""
    dims = {m: DIM for m in mods}
    mfn = load_jax_params(mfn_core.MFN(mods, dims, 1),
                          mfn_core.mfn_init(prng.key(seed), mods, dims, 1))
    return _inputs(mods, B, T, seed, dims), mfn.eval()


def _scan_args(mfn, inputs, dtype=torch.float32):
    mfn = mfn.to(dtype)
    with torch.no_grad():
        xps = mfn_core.hoisted_inputs(
            mfn, {m: torch.from_numpy(v).to(dtype) for m, v in inputs.items()})
    whhs = [getattr(mfn, f"lstm_{m}").weight_hh.detach() for m in mfn.mods]
    return xps, whhs, [g.detach() for g in mfn.gate_tensors()]


def _weights(mods):
    _, mfn = _case(mods)
    whhs = [getattr(mfn, f"lstm_{m}").weight_hh.detach() for m in mods]
    return whhs, [g.detach() for g in mfn.gate_tensors()]


@pytest.mark.parametrize("mods", sorted(MOD_SETS))
def test_packed_views_are_the_weights(mods):
    whhs, gates = _weights(MOD_SETS[mods])
    hid = [w.shape[1] for w in whhs]
    views = mv.packed_views(mv.pack_blockdiag(whhs, gates), hid,
                            gates[4].shape[0], gates[8].shape[0])
    assert (views.c_width, views.c_off) == (sum(hid), mfn_k.offsets(hid))
    for v, w in zip(views.whh, whhs):
        assert torch.equal(v.tensor().reshape(w.shape), w)
    for v, g in zip(views.gates, gates):
        assert torch.equal(v.tensor(), g)


@pytest.mark.parametrize("hp", HPS)
@pytest.mark.parametrize("mods", sorted(MOD_SETS))
def test_aligned_views_are_the_weights(mods, hp):
    """W_hh's real units exactly; each gate tensor's c* lanes (and gamma
    fc1's mem columns) exactly, 0 elsewhere, att1's logit bias -1e9 on the
    pad lanes."""
    whhs, gates = _weights(MOD_SETS[mods])
    hid = [w.shape[1] for w in whhs]
    hps = mv.padded_widths(hid, hp)
    views = mv.aligned_views(mv.pack_aligned(whhs, gates, hp), hid)
    assert (views.c_width, views.c_off) == (sum(hps), mfn_k.offsets(hps))
    for v, w in zip(views.whh, whhs):
        assert torch.equal(v.tensor().reshape(w.shape), w)
    real = mv.cstar_positions(hid, hps)
    mem = gates[6].shape[0]
    k = 2 * sum(hps)
    real_in = torch.cat([real, k + torch.arange(mem)])
    for i, (v, g) in enumerate(zip(views.gates, gates)):
        t = v.tensor()
        if i in (0, 4, 8, 12):    # over c* (and mem): real columns
            cols = real_in if i in (8, 12) else real
            assert torch.equal(t[:, cols], g)
            assert torch.count_nonzero(t) == torch.count_nonzero(g)
        elif i in (2, 3):         # att1 fc2 onto c*: real rows
            assert torch.equal(t[real], g)
            pad = torch.ones(k, dtype=torch.bool)
            pad[real] = False
            want = mv.NEG_PAD if i == 3 else 0.0
            assert bool((t[pad] == want).all())
        else:
            assert torch.equal(t, g)


@pytest.mark.parametrize("layout", ["packed", "aligned"])
def test_view_arguments_of_the_c_entries(layout):
    """The row strides, gate strides and c row the C entry receives, at the
    MFT's A+V+L widths (H 48/88/88, TH = 224, mem 128)."""
    whhs, gates = _weights(MOD_SETS["AVL"])
    views = (mv._packed_views_of(whhs, gates) if layout == "packed"
             else mv._aligned_views_of(whhs, gates, mv.ALIGN_HP))
    _, whh_ld, whh_gate, ptrs, gate_ld, c_off, c_width = mv._view_args(views)
    k = 2 * c_width
    if layout == "packed":
        assert (list(whh_ld), list(whh_gate)) == ([224] * 3, [48, 88, 88])
        assert (list(c_off), c_width) == ([0, 48, 136], 224)
        n3 = 256 + 64 + 64
        assert list(gate_ld) == [k, 1, 128, 1, k + 128, 1, n3, 1,
                                 k + 128, 1, n3, 1, k + 128, 1, n3, 1]
    else:
        assert (list(whh_ld), list(whh_gate)) == ([64, 96, 96], [64, 96, 96])
        assert (list(c_off), c_width) == ([0, 64, 160], 256)
        assert list(gate_ld) == [k, 1, 128, 1, k, 1, 256, 1,
                                 k + 128, 1, 64, 1, k + 128, 1, 64, 1]
    assert list(ptrs) == [v.pointer() for v in views.gates]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_packed_views_through_the_stages_are_kernel_b_bit_for_bit(dtype):
    inputs, mfn = _case(MOD_SETS["AVL"], B=3, T=5)
    xps, whhs, gates = _scan_args(mfn, inputs, dtype)
    views = mv._packed_views_of(whhs, gates)
    with torch.no_grad():
        got = mfn_k.staged_views_plain(xps, views)
        want = mfn_k.staged_plain(xps, whhs, gates)
    for g, w in zip(got, want):
        assert g.dtype == dtype and torch.equal(g, w)


@pytest.fixture(scope="module")
def aligned_case():
    """tests/test_pallas_kernels.py's aligned case: L+A, widths 24/16, and
    the Pallas kernel's output."""
    mods = ("linguistic", "acoustic")
    dims = {"linguistic": 24, "acoustic": 16}
    params = jax.tree_util.tree_map(
        np.asarray, jmfn.mfn_init(jax.random.PRNGKey(11), list(mods), dims, 1))
    inputs = _inputs(mods, 2, 5, 11, dims)
    mfn = load_jax_params(mfn_core.MFN(mods, dims, 1), params).eval()
    want = pk.mfn_scan_pallas_aligned(
        params, {m: jnp.asarray(v) for m, v in inputs.items()}, list(mods),
        interpret=True)
    return inputs, mfn, [np.asarray(w) for w in want]


@pytest.mark.parametrize("hp", HPS)
def test_aligned_stages_match_pallas_interpret(aligned_case, hp):
    inputs, mfn, want = aligned_case
    with torch.no_grad():
        got = mv.mfn_scan_aligned_staged_plain(*_scan_args(mfn, inputs), hp=hp)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("hp", HPS)
@pytest.mark.parametrize("mods", ["AVL", "EA"])
def test_aligned_stages_match_step_plain_float64(mods, hp):
    inputs, mfn = _case(MOD_SETS[mods], B=3, T=6)
    args = _scan_args(mfn, inputs, torch.float64)
    with torch.no_grad():
        got = mv.mfn_scan_aligned_staged_plain(*args, hp=hp)
        want = mv.mfn_scan_aligned_plain(*args, hp=hp)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        torch.testing.assert_close(g, w, rtol=0, atol=F64_TOL)


@pytest.mark.parametrize("hp", HPS)
def test_aligned_layout_fits_the_stages_for_every_mft_modality_set(hp):
    """Every non-empty subset of the four modalities: stage 1 runs the
    views' real units, which fit kernel B's stages (`check_staged_fit`) in
    fp32 and bf16 at the widest batch of a long-video bucket; the padded
    widths would fit too, but for fp32 at hp = 128, where W_hh of 128 units
    passes the 227 KB a block may hold."""
    names = sorted(mfn_core.HIDDEN_DIM)
    widths = (mfn_core.MEM_DIM, mfn_core.H_GAMMA1, mfn_core.H_GAMMA2)
    for n in range(1, len(names) + 1):
        for mods in itertools.combinations(names, n):
            hid = [mfn_core.HIDDEN_DIM[m] for m in mods]
            hps = mv.padded_widths(hid, hp)
            P = mv.AlignedMFN([torch.zeros(4 * p, p) for p in hps],
                              [torch.zeros(1)] * 16, hps)
            real = [v.size[1] for v in mv.aligned_views(P, hid).whh]
            assert real == hid
            for itemsize in (4, 2):
                mfn_k.check_staged_fit(real, *widths, itemsize, 32, 1120,
                                       "test")
                if itemsize == 2 or hp < 128:
                    mfn_k.check_staged_fit(hps, *widths, itemsize, 32, 1120,
                                           "test")


# the entries nvcc -Xptxas -v reports for kernel B's stages on sm_90a (one
# build on the card); chip_smoke.py gates their spills
STAGE_SYMBOLS = [
    f"_ZN4mmtx10mfn_staged{k}I{t}Lb{b}EEEv{args}"
    for k, args in (("16lstm_scan_kernel", "NS_3mfn4ArgsEPf"),
                    ("15mem_scan_kernel", "NS0_7MemArgsE"))
    for t in ("f", "13__nv_bfloat16") for b in (0, 1)] + [
    "_ZN4mmtx10mfn_staged13attend_kernelEPfPKfii",
    "_ZN4mmtx10mfn_staged14ff_gemm_kernelIfNS0_7BiasActIfEEEEvPKfiiiNS0_"
    "6FfJobsIT_T0_EE"]


def _ptxas_entry(symbol: str, spilled: int) -> str:
    return (f"ptxas info    : Compiling entry function '{symbol}' for "
            f"'sm_90a'\nptxas info    : Function properties for {symbol}\n"
            f"    0 bytes stack frame, {spilled} bytes spill stores, "
            f"{spilled} bytes spill loads\nptxas info    : Used 60 "
            "registers\n")


def test_spill_gate_reads_every_instantiation_of_kernel_b_stages():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    entries = [_ptxas_entry(s, 0) for s in STAGE_SYMBOLS]

    def gate(log):
        return cs.spill_gate(log, cs.MFN_STAGED, cs.MFN_STAGED_KERNELS)

    assert gate("".join(entries)) == 0
    spilled = _ptxas_entry(STAGE_SYMBOLS[0], 4)
    assert gate("".join(entries[1:]) + spilled) == 8
    with pytest.raises(cs.SmokeFailure, match="cannot check"):
        gate("".join(entries[:3] + entries[4:]))  # one scan missing
