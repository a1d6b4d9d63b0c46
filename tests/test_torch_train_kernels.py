"""Port parity for the training kernels' plain versions (their CPU path),
float32 on the CPU, against the JAX package's Pallas training kernels run in
interpret mode:

  * the fmix32 keep bits of `ops/basic.py` against `basic.hash_keep_mask`,
    exactly, for several seeds, rates and positions up to the 32-bit wrap;
  * `EncoderStackTrain` (kernels 3 and 4) against `encoder_stack_fused_train`
    at p = 0.1 and p = 0: D=64, h=4, F=32, 2 layers, B=3, T=13 with lengths
    [13, 9, 1]; output on valid rows and every gradient, atol 1e-4;
  * kernel 5's plain version (the "stack" backward of `EncoderStackTrain`)
    against the JAX package's whole-stack backward `_stack_bwd_call`
    (`MMTX_ENC_BWD=stack`) at p = 0.1 and p = 0, same shapes and atol, and
    equal bit for bit to the loop of kernel 4's plain version; on the
    routes, "stack" calls kernel 5 once per stack with its argument check
    and "perlayer" kernel 4 once per layer, with the same gradients;
  * `MFNStatesTrain` (kernels 6 and 7) against `mfn_states_fused_train` at
    p = 0.2 and p = 0: A+V+L, B=3, T=9; states and every gradient, atol
    2e-5;
  * each new wrapper raises, instead of falling back, on a tensor it routes
    to the kernel but the kernel cannot take.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_transformer_tpu.ops import basic as jbasic
from multimodal_transformer_tpu.ops import mfn_core as jmfn
from multimodal_transformer_tpu.ops.pallas import encoder as jenc
from multimodal_transformer_tpu.ops.pallas.mfn_train import \
    mfn_states_fused_train
from multimodal_transformer_tpu_torch.ops import attention, basic
from multimodal_transformer_tpu_torch.ops import mfn_core
from multimodal_transformer_tpu_torch.ops.cuda import encoder_train as enct
from multimodal_transformer_tpu_torch.ops.cuda import mfn_train as mfnt
from multimodal_transformer_tpu_torch.utils import prng
from multimodal_transformer_tpu_torch.utils.params import (export_params,
                                                           load_jax_params)
from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401


D, H, F, N_LAYERS, B, T = 64, 4, 32, 2, 3, 13
LENGTHS = [13, 9, 1]
ENC_ATOL = 1e-4
MODS = ("acoustic", "image", "linguistic")
MFN_B, MFN_T = 3, 9
MFN_ATOL = 2e-5


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.fixture
def _hash_dropout():
    jbasic.set_dropout_impl("hash")
    yield
    jbasic.set_dropout_impl(None)


def _u32_table(seeds) -> np.ndarray:
    """A JAX int32 seed table as uint32 values in int64."""
    return np.asarray(seeds).view(np.uint32).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 1, 0x2545F491, 0xFFFFFFFF])
@pytest.mark.parametrize("p", [0.0, 0.1, 0.3, 0.5, 0.999])
def test_hash_keep_mask_bits_match_jax(seed, p):
    idx = np.concatenate([np.arange(4096), 2 ** 32 - 1 - np.arange(4096),
                          np.random.RandomState(seed % 1000).randint(
                              0, 2 ** 32, 4096, dtype=np.uint64)])
    want = np.asarray(jbasic.hash_keep_mask(
        jnp.uint32(seed), jnp.asarray(idx.astype(np.uint32)), p))
    got = basic.hash_keep_mask(seed, torch.from_numpy(idx.astype(np.int64)), p)
    np.testing.assert_array_equal(got.numpy(), want)


def test_dropout_matches_jax_hash_dropout(_hash_dropout):
    key = jax.random.PRNGKey(9)
    x = np.random.RandomState(0).randn(5, 7, 11).astype(np.float32)
    want = np.asarray(jbasic.dropout(jnp.asarray(x), key, 0.3))
    seed = int(np.uint32(jbasic.hash_seed(key)))
    got = basic.dropout(torch.from_numpy(x), seed, 0.3).numpy()
    np.testing.assert_array_equal(got, want)


def _lin(rs, fan_in, fan_out):
    k = fan_in ** -0.5
    return {"weight": rs.uniform(-k, k, (fan_out, fan_in)).astype(np.float32),
            "bias": rs.uniform(-k, k, fan_out).astype(np.float32)}


def _norm(rs):
    return {"a_2": (1 + 0.1 * rs.randn(D)).astype(np.float32),
            "b_2": (0.1 * rs.randn(D)).astype(np.float32)}


@pytest.fixture(scope="module")
def enc_case():
    rs = np.random.RandomState(1)
    layers = [{"self_attn": {"linears": [_lin(rs, D, D) for _ in range(4)]},
               "feed_forward": {"w_1": _lin(rs, D, F), "w_2": _lin(rs, F, D)},
               "sublayer": [{"norm": _norm(rs)}, {"norm": _norm(rs)}]}
              for _ in range(N_LAYERS)]
    params = {"layers": layers, "norm": _norm(rs)}
    x = rs.randn(B, T, D).astype(np.float32)
    mask = np.zeros((B, T, 1), np.float32)
    for b, n in enumerate(LENGTHS):
        mask[b, :n] = 1.0
    g = (rs.randn(B, T, D) * mask).astype(np.float32)
    enc = load_jax_params(attention.Encoder(D, F, N_LAYERS), params)
    seeds = jenc.dropout_seed_table(jax.random.PRNGKey(4), N_LAYERS)
    return params, enc, x, mask, g, seeds


@pytest.mark.parametrize("p", [0.1, 0.0])
def test_encoder_stack_train_matches_pallas_interpret(enc_case, p):
    params, enc, x, mask, g, seeds = enc_case

    def f(layers, xx):
        return jenc.encoder_stack_fused_train(layers, xx, jnp.asarray(mask),
                                              H, p, seeds)

    want, vjp = jax.vjp(f, params["layers"], jnp.asarray(x))
    want_dl, want_dx = vjp(jnp.asarray(g))

    xt = torch.from_numpy(x).requires_grad_()
    out = enct.encoder_stack_train(enc, xt, torch.from_numpy(mask), h=H, p=p,
                                   seeds=torch.from_numpy(_u32_table(seeds)))
    out.backward(torch.from_numpy(g))
    valid = mask[..., 0] > 0
    np.testing.assert_allclose(out.detach().numpy()[valid],
                               np.asarray(want)[valid], atol=ENC_ATOL)
    np.testing.assert_allclose(xt.grad.numpy()[valid],
                               np.asarray(want_dx)[valid], atol=ENC_ATOL)
    got = {k: v.grad.numpy() for k, v in enc.layers.named_parameters()}
    want_flat = {}
    for l, lg in enumerate(want_dl):
        for k, v in jax.tree_util.tree_leaves_with_path(lg):
            name = ".".join(str(getattr(e, "key", getattr(e, "idx", e)))
                            for e in k)
            want_flat[f"{l}.{name}"] = np.asarray(v)
    assert set(got) == set(want_flat)
    for k in got:
        np.testing.assert_allclose(got[k], want_flat[k], atol=ENC_ATOL,
                                   err_msg=k)
    enc.zero_grad()


def _grads_by_name(want_dl) -> dict:
    out = {}
    for l, lg in enumerate(want_dl):
        for k, v in jax.tree_util.tree_leaves_with_path(lg):
            name = ".".join(str(getattr(e, "key", getattr(e, "idx", e)))
                            for e in k)
            out[f"{l}.{name}"] = np.asarray(v)
    return out


@pytest.mark.parametrize("p", [0.1, 0.0])
def test_encoder_stack_bwd_plain_matches_pallas_stack_interpret(enc_case, p,
                                                                monkeypatch):
    """The "stack" backward (kernel 5's plain version on the CPU) against
    the JAX package's `_stack_bwd_call` in interpret mode, which
    MMTX_ENC_BWD=stack selects (tile pickers pinned as in the JAX package's
    own test, so that the stack call runs)."""
    params, enc, x, mask, g, seeds = enc_case
    monkeypatch.setenv("MMTX_ENC_BWD", "stack")
    monkeypatch.delenv("MMTX_ENC_BWD_CHUNKS", raising=False)
    monkeypatch.setattr(jenc, "_pick_tile_b_bwd", lambda *a, **k: 1)
    monkeypatch.setattr(jenc, "_pick_tile_b_stack", lambda *a, **k: 1)
    calls = []
    stack_call = jenc._stack_bwd_call

    def counted(*a, **k):
        calls.append(1)
        return stack_call(*a, **k)

    monkeypatch.setattr(jenc, "_stack_bwd_call", counted)

    def f(layers, xx):
        return jenc.encoder_stack_fused_train(layers, xx, jnp.asarray(mask),
                                              H, p, seeds)

    _, vjp = jax.vjp(f, params["layers"], jnp.asarray(x))
    want_dl, want_dx = vjp(jnp.asarray(g))
    assert calls  # the JAX package took its whole-stack backward

    xt = torch.from_numpy(x).requires_grad_()
    out = enct.encoder_stack_train(enc, xt, torch.from_numpy(mask), h=H, p=p,
                                   seeds=torch.from_numpy(_u32_table(seeds)),
                                   backward="stack")
    got = torch.autograd.grad(out, [xt] + list(enc.layers.parameters()),
                              torch.from_numpy(g))
    valid = mask[..., 0] > 0
    np.testing.assert_allclose(got[0].numpy()[valid],
                               np.asarray(want_dx)[valid], atol=ENC_ATOL)
    names = [k for k, _ in enc.layers.named_parameters()]
    want = _grads_by_name(want_dl)
    assert set(names) == set(want)
    for k, v in zip(names, got[1:]):
        np.testing.assert_allclose(v.numpy(), want[k], atol=ENC_ATOL,
                                   err_msg=k)


def test_encoder_stack_bwd_plain_is_the_per_layer_loop(enc_case):
    """Kernel 5's plain version equals kernel 4's plain version called for
    every layer, last first, bit for bit."""
    _, enc, x, mask, g, seeds = enc_case
    table = torch.from_numpy(_u32_table(seeds))
    params = [t.detach() for layer in enc.layers
              for t in enct._layer_tensors(layer)]
    km = torch.from_numpy(mask[..., 0])
    _, saved = enct.encoder_stack_train_fwd_plain(
        params, torch.from_numpy(x), km, table, 0.1, H)
    dx, stacked = enct.encoder_stack_bwd_plain(params, saved,
                                               torch.from_numpy(g), km, table,
                                               0.1, H)
    dy, per_layer = torch.from_numpy(g), [None] * N_LAYERS
    for l in reversed(range(N_LAYERS)):
        dy, per_layer[l] = enct.encoder_layer_bwd_plain(
            params[enct.N_PARAMS * l:enct.N_PARAMS * (l + 1)], saved[l], dy,
            km, table[l], 0.1, H)
    assert torch.equal(dx, dy)
    assert len(stacked) == enct.N_PARAMS
    for i, s in enumerate(stacked):
        assert s.shape == (N_LAYERS,) + tuple(params[i].shape)
        assert torch.equal(s, torch.stack([gl[i] for gl in per_layer]))


@pytest.fixture
def routed(monkeypatch):
    """CPU tensors take the training routes of the card: each wrapper checks
    its arguments as on the card (kernel 5 its own), records its call and
    runs its plain version."""
    calls = []
    monkeypatch.setattr(attention, "use_kernel", lambda t: True)

    def fwd(*a):
        calls.append("fwd")
        return enct.encoder_stack_train_fwd_plain(*a)

    def layer(*a):
        calls.append("layer")
        return enct.encoder_layer_bwd_plain(*a)

    def stack(params, saved, dy, kmask, seeds, p, h, hash4=False):
        enct._stack_bwd_args(params, saved, dy, kmask, seeds, h, "kernel 5")
        calls.append("stack")
        return enct.encoder_stack_bwd_plain(params, saved, dy, kmask, seeds,
                                            p, h, hash4)

    monkeypatch.setattr(enct, "encoder_stack_train_fwd", fwd)
    monkeypatch.setattr(enct, "encoder_layer_bwd", layer)
    monkeypatch.setattr(enct, "encoder_stack_bwd", stack)
    return calls


def test_stack_route_calls_kernel_5_once_per_stack(enc_case, routed):
    _, enc, x, mask, g, seeds = enc_case
    table = torch.from_numpy(_u32_table(seeds))
    grads = {}
    for backward in ("perlayer", "stack"):
        routed.clear()
        xt = torch.from_numpy(x).requires_grad_()
        y = attention.encoder_stack(enc, xt, torch.from_numpy(mask), h=H,
                                    mask_mode="key_query", seeds=table,
                                    backward=backward)
        grads[backward] = torch.autograd.grad(
            y, [xt] + list(enc.parameters()), torch.from_numpy(g))
        assert routed == (["fwd", "stack"] if backward == "stack"
                          else ["fwd"] + ["layer"] * N_LAYERS)
    for a, b in zip(grads["perlayer"], grads["stack"]):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="encoder_backward"):
        attention.encoder_stack(enc, torch.from_numpy(x),
                                torch.from_numpy(mask), h=H,
                                mask_mode="key_query", seeds=table,
                                backward="chunked")


def test_encoder_layer_bwd_plain_is_autograd_of_the_plain_forward(enc_case):
    """Kernel 4's plain version equals autograd through kernel 3's plain
    forward layer by layer (the same keep bits both ways)."""
    _, enc, x, mask, g, seeds = enc_case
    table = torch.from_numpy(_u32_table(seeds))
    params = [t.detach() for layer in enc.layers
              for t in enct._layer_tensors(layer)]
    km = torch.from_numpy(mask[..., 0])
    out, saved = enct.encoder_stack_train_fwd_plain(
        params, torch.from_numpy(x), km, table, 0.1, H)
    lp = params[enct.N_PARAMS:]
    dx, grads = enct.encoder_layer_bwd_plain(lp, saved[1], torch.from_numpy(g),
                                             km, table[1], 0.1, H)
    xl = saved[1].clone().requires_grad_()
    leaves = [t.clone().requires_grad_() for t in lp]
    y = enct.layer_train_plain(leaves, xl, km, table[1], 0.1, H)
    want = torch.autograd.grad(y, [xl] + leaves, torch.from_numpy(g))
    for a, b in zip([dx] + grads, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_plain_encoder_training_matches_jnp(enc_case, _hash_dropout):
    """The model's plain training path (ops/attention.py) against the JAX
    package's jnp encoder_stack with the same key, query and key_query."""
    from multimodal_transformer_tpu.ops import attention as jattn
    params, enc, x, mask, _, _ = enc_case
    key = jax.random.PRNGKey(4)
    for mode in ("query", "key_query"):
        want = jattn.encoder_stack(params, jnp.asarray(x), jnp.asarray(mask),
                                   h=H, rng=key, mask_mode=mode)
        with torch.no_grad():
            got = attention.encoder_stack(
                enc, torch.from_numpy(x), torch.from_numpy(mask), h=H,
                mask_mode=mode, seeds=torch.from_numpy(_u32_table(
                    jenc.dropout_seed_table(key, N_LAYERS))))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=ENC_ATOL, err_msg=mode)


@pytest.fixture(scope="module")
def mfn_case():
    dims = {m: 12 for m in MODS}
    mfn = load_jax_params(mfn_core.MFN(MODS, dims, 1),
                          mfn_core.mfn_init(prng.key(6), MODS, dims, 1))
    params = export_params(mfn)
    rs = np.random.RandomState(7)
    inputs = {m: rs.randn(MFN_B, MFN_T, 12).astype(np.float32) for m in MODS}
    with torch.no_grad():
        xps = [x.contiguous() for x in mfn_core.hoisted_inputs(
            mfn, {m: torch.from_numpy(v) for m, v in inputs.items()})]
    TH = sum(mfn_core.HIDDEN_DIM[m] for m in MODS)
    g_hs = rs.randn(MFN_B, MFN_T, TH).astype(np.float32)
    g_mems = rs.randn(MFN_B, MFN_T, mfn_core.MEM_DIM).astype(np.float32)
    seeds = rs.randint(0, 2 ** 32, (MFN_T, 2), dtype=np.uint64).astype(
        np.int64)
    return params, mfn, xps, g_hs, g_mems, seeds


@pytest.mark.parametrize("p", [0.2, 0.0])
def test_mfn_states_train_matches_pallas_interpret(mfn_case, p):
    params, mfn, xps, g_hs, g_mems, seeds = mfn_case
    names = ["att1_fc1", "att1_fc2", "att2_fc1", "att2_fc2", "gamma1_fc1",
             "gamma1_fc2", "gamma2_fc1", "gamma2_fc2"]
    gp = {f"whh_{m}": params[f"lstm_{m}"]["weight_hh"] for m in MODS}
    gp.update({n: params[n] for n in names})
    jxps = {m: jnp.asarray(x.numpy().transpose(1, 0, 2))
            for m, x in zip(MODS, xps)}
    jseeds = jnp.asarray(seeds.astype(np.uint32).view(np.int32))

    def f(gp_, xps_):
        return mfn_states_fused_train(gp_, xps_, jseeds, MODS, (p, p))

    (want_hs, want_mems), vjp = jax.vjp(f, gp, jxps)
    want_gp, want_dxps = vjp((jnp.asarray(g_hs.transpose(1, 0, 2)),
                              jnp.asarray(g_mems.transpose(1, 0, 2))))

    xs = [x.clone().requires_grad_() for x in xps]
    whhs = [getattr(mfn, f"lstm_{m}").weight_hh for m in MODS]
    gates = mfn.gate_tensors()
    hs, mems = mfnt.mfn_states_train(xs, whhs, gates, torch.from_numpy(seeds),
                                     (p, p))
    np.testing.assert_allclose(hs.detach().numpy(),
                               np.asarray(want_hs).transpose(1, 0, 2),
                               atol=MFN_ATOL)
    np.testing.assert_allclose(mems.detach().numpy(),
                               np.asarray(want_mems).transpose(1, 0, 2),
                               atol=MFN_ATOL)
    torch.autograd.backward([hs, mems], [torch.from_numpy(g_hs),
                                         torch.from_numpy(g_mems)])
    for m, x in zip(MODS, xs):
        np.testing.assert_allclose(
            x.grad.numpy(), np.asarray(want_dxps[m]).transpose(1, 0, 2),
            atol=MFN_ATOL, err_msg=m)
        np.testing.assert_allclose(
            getattr(mfn, f"lstm_{m}").weight_hh.grad.numpy(),
            np.asarray(want_gp[f"whh_{m}"]), atol=MFN_ATOL, err_msg=m)
    for n in names:
        for k in ("weight", "bias"):
            np.testing.assert_allclose(
                getattr(getattr(mfn, n), k).grad.numpy(),
                np.asarray(want_gp[n][k]), atol=MFN_ATOL, err_msg=f"{n}.{k}")
    mfn.zero_grad()


def test_mfn_train_bwd_plain_is_autograd_of_the_plain_forward(mfn_case):
    """In float32 the stored states are the carried ones, so kernel 7's
    plain version equals autograd through kernel 6's plain forward."""
    _, mfn, xps, g_hs, g_mems, seeds = mfn_case
    whhs = [getattr(mfn, f"lstm_{m}").weight_hh.detach() for m in MODS]
    gates = [g.detach() for g in mfn.gate_tensors()]
    ps = (0.2, 0.2)
    hs, cs, mems = mfnt.mfn_train_fwd_plain(xps, whhs, gates, seeds, ps)
    d_xps, d_whhs, d_gates = mfnt.mfn_train_bwd_plain(
        xps, whhs, gates, seeds, ps, hs, cs, mems, torch.from_numpy(g_hs),
        torch.from_numpy(g_mems))
    leaves = [t.clone().requires_grad_() for t in xps + whhs + gates]
    n = len(MODS)
    hs2, _, mems2 = mfnt.mfn_train_fwd_plain(leaves[:n], leaves[n:2 * n],
                                             leaves[2 * n:], seeds, ps)
    want = torch.autograd.grad([hs2, mems2], leaves,
                               [torch.from_numpy(g_hs),
                                torch.from_numpy(g_mems)])
    for a, b in zip(list(d_xps) + list(d_whhs) + list(d_gates), want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_mfn_head_out_dropout_indexes_time_major(mfn_case, _hash_dropout):
    """The head's out-dropout keeps the bits of the JAX package's
    time-major [T, B, 64] hidden, and the whole training MFN matches
    `mfn_scan(rng=key)` (its jnp scan with hoisted hash seeds)."""
    params, mfn, _, _, _, _ = mfn_case
    rs = np.random.RandomState(8)
    inputs = {m: rs.randn(MFN_B, MFN_T, 12).astype(np.float32) for m in MODS}
    key = jax.random.PRNGKey(11)
    want = jmfn.mfn_scan(params, {m: jnp.asarray(v) for m, v in inputs.items()},
                         MODS, rng=key)
    steps = jax.random.split(key, MFN_T)
    sub = jax.vmap(lambda k: jax.random.split(k, 2))(steps)
    seeds = jax.vmap(lambda ks: jnp.stack([jbasic.hash_seed(ks[0]),
                                           jbasic.hash_seed(ks[1])]))(sub)
    out_seed = int(np.uint32(jbasic.hash_seed(jax.random.fold_in(key, 7))))
    with torch.no_grad():
        got = mfn_core.mfn_scan(
            mfn, {m: torch.from_numpy(v) for m, v in inputs.items()},
            torch.from_numpy(np.asarray(seeds).astype(np.int64)), out_seed)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MFN_ATOL)


def test_cuda_wrappers_raise_without_a_kernel(enc_case, mfn_case,
                                              monkeypatch):
    """A tensor routed to a training kernel that the kernel cannot take
    (float64 here) raises instead of falling back to the plain version
    (checked by routing CPU tensors as if they were on CUDA)."""
    monkeypatch.setattr(enct, "use_kernel", lambda t: True)
    monkeypatch.setattr(mfnt, "use_kernel", lambda t: True)
    _, enc, x, mask, g, seeds = enc_case
    table = torch.from_numpy(_u32_table(seeds))
    params = [t.detach().double() for layer in enc.layers
              for t in enct._layer_tensors(layer)]
    x64 = torch.from_numpy(x).double()
    km = torch.from_numpy(mask[..., 0]).double()
    with pytest.raises(TypeError):
        enct.encoder_stack_train_fwd(params, x64, km, table, 0.1, H)
    with pytest.raises(TypeError):
        enct.encoder_layer_bwd(params[:enct.N_PARAMS], x64, x64, km, table[0],
                               0.1, H)
    saved = torch.zeros((N_LAYERS,) + x64.shape, dtype=torch.float64)
    with pytest.raises(TypeError):
        enct.encoder_stack_bwd(params, saved, x64, km, table, 0.1, H)
    saved32, dy32 = saved.float(), x64.float()
    with pytest.raises(ValueError):  # one layer's parameters for two
        enct.encoder_stack_bwd([t.float() for t in params[:enct.N_PARAMS]],
                               saved32, dy32, km, table, 0.1, H)
    with pytest.raises(ValueError):  # d_k = 64 / 5 heads: no kernel
        enct.encoder_stack_bwd([t.float() for t in params], saved32, dy32,
                               km, table, 0.1, 5)
    _, mfn, xps, g_hs, g_mems, s = mfn_case
    xp64 = [v.double() for v in xps]
    whhs = [getattr(mfn, f"lstm_{m}").weight_hh.detach().double()
            for m in MODS]
    gates = [v.detach().double() for v in mfn.gate_tensors()]
    with pytest.raises(TypeError):
        mfnt.mfn_train_fwd(xp64, whhs, gates, s, (0.2, 0.2))
    hs = torch.zeros(MFN_B, MFN_T, g_hs.shape[-1], dtype=torch.float64)
    mems = torch.zeros(MFN_B, MFN_T, g_mems.shape[-1], dtype=torch.float64)
    with pytest.raises(TypeError):
        mfnt.mfn_train_bwd(xp64, whhs, gates, s, (0.2, 0.2), hs, hs, mems,
                           torch.from_numpy(g_hs), torch.from_numpy(g_mems))
