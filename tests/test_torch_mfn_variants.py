"""Port parity for rows 8 and 9 of the kernel table, float32 on the CPU: the
packed and aligned MFN recurrences (ops/cuda/mfn_variants.py) against the
JAX package's `mfn_scan_pallas_packed` and `mfn_scan_pallas_aligned` in
interpret mode, at the cases of tests/test_pallas_kernels.py and with its
tolerance (rtol 1e-5, atol 1e-6) on hs, mems and the head's output.  The
packers match the JAX ones exactly, after the [out, in] -> [in, out]
transpose; the aligned layout's pad lanes stay exactly 0; the wrappers take
their plain versions on the CPU and raise on what they do not take; the
port's `bench_mfn_kernel` runs on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_transformer_tpu.ops import mfn_core as jmfn
from multimodal_transformer_tpu.ops.basic import linear as jlinear
from multimodal_transformer_tpu.ops.pallas import mfn_kernel as pk
from multimodal_transformer_tpu_torch import bench_mfn_kernel
from multimodal_transformer_tpu_torch.ops import mfn_core
from multimodal_transformer_tpu_torch.ops.cuda import mfn as mfn_k
from multimodal_transformer_tpu_torch.ops.cuda import mfn_variants as mv
from multimodal_transformer_tpu_torch.utils.params import load_jax_params
from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401


RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _case(mods, dims, key, B, T):
    params = jax.tree_util.tree_map(
        np.asarray, jmfn.mfn_init(jax.random.PRNGKey(key), list(mods), dims,
                                  1))
    rs = np.random.RandomState(key)
    inputs = {m: rs.randn(B, T, dims[m]).astype(np.float32) for m in mods}
    mfn = load_jax_params(mfn_core.MFN(mods, dims, 1), params).eval()
    with torch.no_grad():
        xps = mfn_core.hoisted_inputs(
            mfn, {m: torch.from_numpy(v) for m, v in inputs.items()})
    whhs = [getattr(mfn, f"lstm_{m}").weight_hh.detach() for m in mods]
    gates = [g.detach() for g in mfn.gate_tensors()]
    return params, inputs, mfn, (xps, whhs, gates)


@pytest.fixture(scope="module")
def packed_case():
    """tests/test_pallas_kernels.py's packed case: A+V+L, width 24."""
    mods = ("acoustic", "image", "linguistic")
    return mods, _case(mods, {m: 24 for m in mods}, 13, 3, 7)


@pytest.fixture(scope="module")
def aligned_case():
    """tests/test_pallas_kernels.py's aligned case: L+A, widths 24/16."""
    mods = ("linguistic", "acoustic")
    return mods, _case(mods, {"linguistic": 24, "acoustic": 16}, 11, 2, 5)


def _jax_head(params, hs, mems):
    feats = jnp.concatenate([hs, mems], axis=2)
    return jlinear(params["out_fc2"],
                   jax.nn.relu(jlinear(params["out_fc1"], feats)))


def _assert_states_and_head(mfn, params, got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)
    with torch.no_grad():
        head = mfn_core.mfn_head(mfn, *got)
    np.testing.assert_allclose(head.numpy(),
                               np.asarray(_jax_head(params, *want)),
                               rtol=RTOL, atol=ATOL)


def test_blockdiag_packing_matches_jax(packed_case):
    mods, (params, _, mfn, _) = packed_case
    got = mv.pack_mfn_params_blockdiag(mfn)
    want = pk.pack_mfn_params_blockdiag(params, list(mods))
    names = {"whh": "whh_bd", "a1w1": "a1w1", "a1b1": "a1b1", "a1w2": "a1w2",
             "a1b2": "a1b2", "w1g": "w1g", "b1g": "b1g", "w2bd": "w2bd",
             "b2g": "b2g"}
    for port, jname in names.items():
        t = getattr(got, port).detach().numpy()
        np.testing.assert_array_equal(t.T if t.ndim == 2 else t,
                                      np.asarray(want[jname]))


def test_aligned_packing_at_hp_128_matches_jax(aligned_case):
    mods, (params, _, mfn, _) = aligned_case
    got = mv.pack_mfn_params_aligned(mfn, hp=128)
    want = pk.pack_mfn_params_aligned(params, list(mods))
    assert got.hps == [pk.HP] * len(mods)
    for m, w in zip(mods, got.whhs):
        np.testing.assert_array_equal(w.detach().numpy().T,
                                      np.asarray(want[f"whh_{m}"]))
    names = ["a1w1", "a1b1", "a1w2", "a1b2", "a2w1", "a2b1", "a2w2", "a2b2"]
    names += [f"{g}{k}" for g in ("gamma1", "gamma2")
              for k in ("w1", "b1", "w2", "b2")]
    for name, t in zip(names, got.gates):
        t = t.detach().numpy()
        np.testing.assert_array_equal(t.T if t.ndim == 2 else t,
                                      np.asarray(want[name]))


def test_packed_plain_matches_pallas_interpret(packed_case):
    mods, (params, inputs, mfn, args) = packed_case
    want = pk.mfn_scan_pallas_packed(
        params, {m: jnp.asarray(v) for m, v in inputs.items()}, list(mods),
        interpret=True)
    with torch.no_grad():
        got = mv.mfn_scan_packed_plain(*args)
    _assert_states_and_head(mfn, params, got, want)


@pytest.mark.parametrize("hp", [mv.ALIGN_HP, 128])
def test_aligned_plain_matches_pallas_interpret(aligned_case, hp):
    mods, (params, inputs, mfn, args) = aligned_case
    want = pk.mfn_scan_pallas_aligned(
        params, {m: jnp.asarray(v) for m, v in inputs.items()}, list(mods),
        interpret=True)
    with torch.no_grad():
        got = mv.mfn_scan_aligned_plain(*args, hp=hp)
    _assert_states_and_head(mfn, params, got, want)


@pytest.mark.parametrize("hp", [mv.ALIGN_HP, 128])
def test_aligned_pad_lanes_stay_exactly_zero(aligned_case, hp):
    """h and c are 0 on the pad lanes at every step, and so is att1's
    feature softmax (the -1e9 bias)."""
    _, (_, _, _, (xps, whhs, gates)) = aligned_case
    hid = [w.shape[1] for w in whhs]
    P = mv.pack_aligned(whhs, gates, hp)
    xp = [mv.pad_xp(x, H, HP) for x, H, HP in zip(xps, hid, P.hps)]
    B, T = xps[0].shape[:2]
    h = [torch.zeros(B, HP) for HP in P.hps]
    c = [torch.zeros(B, HP) for HP in P.hps]
    mem = torch.zeros(B, gates[6].shape[0])
    real = torch.zeros(2 * sum(P.hps), dtype=torch.bool)
    real[mv.cstar_positions(hid, P.hps)] = True
    with torch.no_grad():
        for t in range(T):
            h, c, mem, att = mv.aligned_step([x[:, t] for x in xp], h, c,
                                             mem, P)
            for H, hv, cv in zip(hid, h, c):
                assert torch.count_nonzero(hv[:, H:]) == 0
                assert torch.count_nonzero(cv[:, H:]) == 0
            assert torch.count_nonzero(att[:, ~real]) == 0
            assert bool((att[:, real] > 0).all())


def test_padded_widths():
    assert mv.padded_widths([48, 88, 88, 16], mv.ALIGN_HP) == [64, 96, 96, 32]
    assert mv.padded_widths([48, 88, 88, 16], 128) == [128] * 4
    with pytest.raises(ValueError):
        mv.padded_widths([48], 0)


@pytest.mark.parametrize("variant", ["packed", "aligned"])
def test_wrapper_takes_its_plain_version_on_the_cpu(packed_case, variant):
    _, (_, _, _, args) = packed_case
    wrapper = getattr(mv, f"mfn_scan_{variant}")
    plain = getattr(mv, f"mfn_scan_{variant}_plain")
    with torch.no_grad():
        for a, b in zip(wrapper(*args), plain(*args)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("variant", ["packed", "aligned"])
@pytest.mark.parametrize("bad", ["whh_count", "gate_count", "xp_shape",
                                 "odd_width"])
def test_wrapper_raises_on_bad_shapes(packed_case, variant, bad):
    _, (_, _, _, (xps, whhs, gates)) = packed_case
    if bad == "whh_count":
        whhs = whhs[:2]
    elif bad == "gate_count":
        gates = gates[:15]
    elif bad == "xp_shape":
        xps = [xps[0][:, :5]] + list(xps[1:])
    else:
        odd = mfn_core.MFN(("acoustic", "image", "linguistic"),
                           {m: 24 for m in ("acoustic", "image",
                                            "linguistic")}, 1)
        odd.att1_fc1 = torch.nn.Linear(odd.att1_fc1.in_features, 127)
        odd.att1_fc2 = torch.nn.Linear(127, odd.att1_fc2.out_features)
        gates = [g.detach() for g in odd.gate_tensors()]
    with pytest.raises(ValueError):
        getattr(mv, f"mfn_scan_{variant}")(xps, whhs, gates)


@pytest.mark.parametrize("variant", ["packed", "aligned"])
def test_wrapper_on_the_card_refuses_autograd(packed_case, variant,
                                              monkeypatch):
    """Routed as if the tensors were on the card: with an input that
    requires grad the wrapper raises before it builds or launches."""
    _, (_, _, _, (xps, whhs, gates)) = packed_case
    monkeypatch.setattr(mv, "use_kernel", lambda t: True)
    xps = [x.clone().requires_grad_() for x in xps]
    with pytest.raises(RuntimeError, match="no backward"):
        getattr(mv, f"mfn_scan_{variant}")(xps, whhs, gates)


def test_kernel_b_and_the_variants_agree_on_the_cpu(packed_case):
    _, (_, _, _, args) = packed_case
    with torch.no_grad():
        want = mfn_k.mfn_scan_fused_plain(*args)
        for got in (mv.mfn_scan_packed(*args), mv.mfn_scan_aligned(*args)):
            for g, w in zip(got, want):
                torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL)


def test_bench_prints_a_line_for_each_candidate(capsys):
    rc = bench_mfn_kernel.main(["--device", "cpu", "--batch", "1", "--steps",
                                "2", "--reps", "1"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    assert "on the CPU" in lines[0]
    rows = lines[1:]
    assert len(rows) == len(bench_mfn_kernel.CONFIGS) * len(
        bench_mfn_kernel.DTYPES) * len(bench_mfn_kernel.CANDIDATES)
    for config in bench_mfn_kernel.CONFIGS:
        for name in bench_mfn_kernel.CANDIDATES:
            # the line's columns: configuration, dtype, candidate
            assert sum(r[:13].strip() == config and r[24:33].strip() == name
                       and r.endswith("PASS") for r in rows) == 2
