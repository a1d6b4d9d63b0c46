"""The port's "hash4" dropout stream against the JAX package's
`set_dropout_impl("hash4")`, float32 on the CPU:

  * `basic.hash4_keep_rows` against the JAX `hash4_keep_rows` bit for bit,
    and `basic.dropout` under a `Hash4Seed` against the JAX `dropout` at
    last axes 64 and 256 (multi-bit) and 30 (the per-element fallback);
  * the encoder stack's training route (kernels 3, 4 and 5's plain
    versions, "perlayer" and "stack" backwards) and its plain path with
    `hash4=True` against the JAX `encoder_stack` and the Pallas
    `encoder_stack_fused_train` in interpret mode at T = 24 (a multi-bit
    attention site) and T = 21 (its fallback), forward and gradients at
    tests/test_pallas_kernels.py's hash4 tolerances;
  * the MFN head's time-major `out` site, one device and a data-parallel
    rank's rows, against the JAX dropout of the time-major hidden;
  * `DropoutSeeds.from_key(..., "hash4")`: the hash's values, the scalar
    sites tagged, the stream on `DropoutSeeds.hash4`; `for_rows` per site against the global
    mask at the rank's rows, multi-bit and fallback;
  * a training step of MFT A+V+L, SFT and B1-LSTM (every generic site's
    width) against `jax.value_and_grad` of the JAX apply, and an MFT A+V+L
    `Engine(dropout_impl="hash4")` epoch against the JAX Engine, at the
    existing train-parity tolerances.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from make_goldens import SMALL_DIMS

from multimodal_transformer_tpu.engine import Engine as JEngine
from multimodal_transformer_tpu.models import build_model as jbuild_model
from multimodal_transformer_tpu.models import default_config as jdefault_config
from multimodal_transformer_tpu.ops import attention as jattn
from multimodal_transformer_tpu.ops import basic as jbasic
from multimodal_transformer_tpu.ops.norm import torch_layer_norm
from multimodal_transformer_tpu.ops.pallas import encoder as jenc
from multimodal_transformer_tpu_torch import build_model, default_config
from multimodal_transformer_tpu_torch.engine import Engine
from multimodal_transformer_tpu_torch.ops import attention, basic, mfn_core
from multimodal_transformer_tpu_torch.ops.cuda import encoder_train as enct
from multimodal_transformer_tpu_torch.ops.seeds import HASH_MUL, DropoutSeeds
from multimodal_transformer_tpu_torch.utils import prng
from multimodal_transformer_tpu_torch.utils.params import (export_params,
                                                           flatten_tree,
                                                           load_jax_params)
from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401

AVL = ("acoustic", "image", "linguistic")
H, D, FF, N_LAYERS, B = 8, 64, 32, 2, 5
P_ENC = 0.3
# tests/test_pallas_kernels.py test_encoder_train_kernel_hash4_parity
FWD_RTOL, FWD_ATOL, GRAD_TOL = 1e-4, 2e-5, 2e-4
# tests/test_torch_prng.py's train-step tolerance
GRAD_RTOL, GRAD_FLOOR = 1e-4, 1e-6


@pytest.fixture
def hash4():
    torch.backends.cuda.matmul.allow_tf32 = False
    jbasic.set_dropout_impl("hash4")
    try:
        yield
    finally:
        jbasic.set_dropout_impl(None)


def _seed(key) -> int:
    return int(np.asarray(jbasic.hash_seed(key)).astype(np.uint32))


@pytest.mark.parametrize("p", [0.1, 0.3, 0.5, 0.999])
@pytest.mark.parametrize("width", [64, 256])
def test_hash4_keep_rows_bits_equal_jax(width, p):
    for seed in (0, 0x2545F491, 0xFFFFFFFF):
        want = np.asarray(jbasic.hash4_keep_rows(jnp.uint32(seed), 37, width,
                                                 p))
        got = basic.hash4_keep_rows(seed, 37, width, p)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [(3, 5, 64), (2, 30), (4, 7, 256),
                                   (2, 3, 30)])
def test_dropout_equals_jax_hash4_dropout(shape, hash4):
    key = jax.random.PRNGKey(9)
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    want = np.asarray(jbasic.dropout(jnp.asarray(x), key, 0.3))
    seed = basic.Hash4Seed(_seed(key))
    got = basic.dropout(torch.from_numpy(x), seed, 0.3).numpy()
    np.testing.assert_array_equal(got, want)
    # a plain int seed is the hash stream: another mask where w % 4 == 0
    plain = basic.dropout(torch.from_numpy(x), int(seed), 0.3).numpy()
    assert (plain == want).all() == (shape[-1] % 4 != 0)


# ------------------------------------------------------- the encoder


def _enc_setup(seed, T):
    """tests/test_pallas_kernels.py's _enc_setup at D = 64, F = 32, two
    layers perturbed apart, variable padding."""
    params = jattn.encoder_init(jax.random.PRNGKey(seed), D, FF, N_LAYERS)
    params["layers"] = [jax.tree_util.tree_map(lambda w, i=i: w + 0.01 * i,
                                               lp)
                        for i, lp in enumerate(params["layers"])]
    rs = np.random.RandomState(seed)
    x = rs.randn(B, T, D).astype(np.float32)
    mask = np.ones((B, T, 1), np.float32)
    for i in range(B):
        mask[i, T - i * 3:] = 0.0
    g = (np.random.RandomState(3).randn(B, T, D) * mask).astype(np.float32)
    enc = load_jax_params(attention.Encoder(D, FF, N_LAYERS), params)
    return params, enc, x, mask, g


def _table(key):
    return torch.from_numpy(np.asarray(
        jenc.dropout_seed_table(key, N_LAYERS)).view(np.uint32).astype(
            np.int64))


def _named(tree) -> dict:
    return {".".join(str(getattr(e, "key", getattr(e, "idx", e)))
                     for e in k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("T", [24, 21])
def test_encoder_training_route_equals_jax_under_hash4(T, hash4):
    """Kernels 3/4/5's plain versions and the plain stack against the JAX
    jnp stack and its Pallas train kernels (interpret) under hash4."""
    params, enc, x, mask, g = _enc_setup(29, T)
    key = jax.random.PRNGKey(42)
    jm = jnp.asarray(mask)

    def loss_jnp(p, xx):
        y = jattn.encoder_stack(p, xx, jm, h=H, rng=key, dropout_p=P_ENC,
                                mask_mode="key_query")
        return jnp.sum(y * g), y

    def loss_ker(p, xx):
        s = jenc.dropout_seed_table(key, len(p["layers"]))
        y = jenc.encoder_stack_fused_train(p["layers"], xx, jm, H, P_ENC, s)
        y = torch_layer_norm(p["norm"], y.astype(xx.dtype))
        return jnp.sum(y * g), y

    valid = mask[..., 0] == 1
    wants = [jax.grad(f, argnums=(0, 1), has_aux=True)(params,
                                                       jnp.asarray(x))
             for f in (loss_jnp, loss_ker)]
    table = _table(key)
    for backward in ("perlayer", "stack"):
        xt = torch.from_numpy(x).requires_grad_()
        y = enct.encoder_stack_train(enc, xt, torch.from_numpy(mask), h=H,
                                     p=P_ENC, seeds=table, backward=backward,
                                     hash4=True)
        y = enc.norm(y)
        grads = torch.autograd.grad((y * torch.from_numpy(g)).sum(),
                                    [xt] + list(enc.parameters()))
        got = {k: v.numpy() for (k, _), v in zip(enc.named_parameters(),
                                                 grads[1:])}
        for (want_p, want_x), want_y in wants:
            np.testing.assert_allclose(y.detach().numpy()[valid],
                                       np.asarray(want_y)[valid],
                                       rtol=FWD_RTOL, atol=FWD_ATOL)
            np.testing.assert_allclose(grads[0].numpy(), np.asarray(want_x),
                                       rtol=GRAD_TOL, atol=GRAD_TOL)
            want = _named(want_p)
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=GRAD_TOL,
                                           atol=GRAD_TOL,
                                           err_msg=f"{backward} {k}")
    with torch.no_grad():  # the plain path takes the stream too
        plain = attention.encoder_stack_plain(
            enc, torch.from_numpy(x), torch.from_numpy(mask), h=H,
            mask_mode="key_query", seeds=table, dropout_p=P_ENC, hash4=True)
    np.testing.assert_allclose(plain.numpy()[valid],
                               np.asarray(wants[0][1])[valid],
                               rtol=FWD_RTOL, atol=FWD_ATOL)


def test_kernel_stream_argument():
    """The C entries' stream argument: the 8-bit threshold on the hash4
    stream, -1 on the hash stream."""
    assert enct._hash4_t8(False, 0.1) == -1
    assert enct._hash4_t8(True, 0.1) == 26
    assert enct._hash4_t8(True, 0.5) == 128


# ------------------------------------------------ the MFN's out site


def test_mfn_head_out_site_is_the_time_major_hash4_mask(hash4):
    """The head's out site on a [B, T, 64] hidden: the JAX dropout of the
    time-major [T, B, 64] hidden, transposed; a rank's rows (r0, rows) the
    global mask's rows."""
    Bg, T, W = 6, 5, 64
    key = jax.random.PRNGKey(3)
    h = np.random.RandomState(1).rand(Bg, T, W).astype(np.float32) + 0.5
    want = np.asarray(jbasic.dropout(jnp.asarray(h.transpose(1, 0, 2)), key,
                                     0.5)).transpose(1, 0, 2)
    seed = basic.Hash4Seed(_seed(key))

    class Head(torch.nn.Module):  # identity layers: the head's dropout alone
        def __init__(self):
            super().__init__()
            self.out_fc1 = torch.nn.Identity()
            self.out_fc2 = torch.nn.Identity()

    hs = torch.from_numpy(h)
    got = mfn_core.mfn_head(Head(), hs, hs[..., :0], seed)
    np.testing.assert_array_equal(got.numpy(), want)
    r0, local = 2, 3
    part = mfn_core.mfn_head(Head(), hs[r0:r0 + local], hs[r0:r0 + local, :, :0],
                             seed, out_rows=(r0, Bg))
    np.testing.assert_array_equal(part.numpy(), want[r0:r0 + local])


# --------------------------------------------------------- the seeds


def _sites(family, mods):
    cfg = default_config(family, mods, mask_mode="key_query")
    object.__setattr__(cfg, "mod_dimension", dict(SMALL_DIMS))
    return build_model(cfg, device="meta").dropout_sites()


@pytest.mark.parametrize("family,mods", [("MFT", AVL), ("B1-LSTM", AVL),
                                         ("SFT", AVL)])
def test_from_key_tags_the_hash_seeds(family, mods):
    sites, T = _sites(family, mods), 9
    key = prng.fold_in(prng.key(2), 1)
    hashed = DropoutSeeds.from_key(sites, key, T)
    tagged = DropoutSeeds.from_key(sites, key, T, "hash4")
    assert tagged.hash4 and not hashed.hash4 and not tagged.threefry()
    for a, b in zip((*hashed.front.values(), hashed.out, hashed.embed,
                     hashed.decoder),
                    (*tagged.front.values(), tagged.out, tagged.embed,
                     tagged.decoder)):
        assert a == b and (b is None or isinstance(b, basic.Hash4Seed))
    for name, t in hashed.encoder.items():
        assert type(tagged.encoder[name]) is torch.Tensor
        assert torch.equal(tagged.encoder[name], t)
    if hashed.mfn is not None:  # the gamma sites stay per-element
        assert not basic.is_hash4(tagged.mfn)
        assert torch.equal(tagged.mfn, hashed.mfn)


@pytest.mark.parametrize("T", [24, 21])
def test_for_rows_draws_the_global_mask_at_the_rank_rows(T):
    """Each site's mask under a rank's shifted seed equals the global
    batch's mask at the rank's rows: multi-bit sites shifted by a quarter
    of their elements per row, the fallback ones (T % 4 != 0 at the
    attention probabilities) by all of them."""
    sites = _sites("MFT", AVL)
    Bg, r0, local = 6, 3, 3
    seeds = DropoutSeeds.from_key(sites, prng.key(5), T, "hash4")
    mine = seeds.for_rows(sites, r0, Bg, T)
    assert mine.hash4 and mine.rows == (r0, Bg)

    def check(seed_g, seed_r, shape, p=0.3):
        x = torch.ones(Bg, *shape)
        want = basic.dropout(x, seed_g, p)[r0:r0 + local]
        got = basic.dropout(x[r0:r0 + local], seed_r, p)
        assert torch.equal(got, want)
        unshifted = basic.dropout(x[r0:r0 + local], seed_g, p)
        assert not torch.equal(unshifted, want)

    for m, e in zip(sites.front, sites.front_widths):
        check(seeds.front[m], mine.front[m], (T, e))
    for name, (d, f, h) in zip(sites.encoders, sites.encoder_dims):
        g, r = seeds.encoder[name][1], mine.encoder[name][1]
        for i, shape in enumerate(((h, T, T), (T, d), (T, f), (T, d))):
            check(basic.site_seed(g[i], True), basic.site_seed(r[i], True),
                  shape)
    # the gamma table keeps the hash's shift (per-element bits)
    want = (seeds.mfn + r0 * sites.gamma_widths[0] * HASH_MUL) & 0xFFFFFFFF
    assert torch.equal(mine.mfn[:, 0], want[:, 0])
    assert mine.out == seeds.out


# ------------------------------------------- the step and the epoch


FAMILY_CASES = {"mft_avl": ("MFT", AVL), "sft_avl": ("SFT", AVL),
                "b1_avl": ("B1-LSTM", AVL)}


def _grad_errors(got: dict, want: dict) -> float:
    total = np.sqrt(sum(float(np.sum(np.square(v, dtype=np.float64)))
                        for v in want.values()))
    worst = 0.0
    for k, w in want.items():
        diff = np.linalg.norm((got[k] - w).ravel())
        limit = GRAD_RTOL * np.linalg.norm(w.ravel()) + GRAD_FLOOR * total
        worst = max(worst, diff / limit)
    return worst


@pytest.mark.parametrize("name", sorted(FAMILY_CASES))
def test_hash4_train_step_matches_jax(name, hash4):
    family, mods = FAMILY_CASES[name]
    jcfg = jdefault_config(family, mods, mask_mode="key_query")
    cfg = default_config(family, mods, mask_mode="key_query")
    for c in (jcfg, cfg):
        object.__setattr__(c, "mod_dimension", dict(SMALL_DIMS))
    module = build_model(cfg, seed=6)
    params = export_params(module)
    _, apply = jbuild_model(jcfg)
    Bs, T = 2, 8
    rs = np.random.RandomState(4)
    frames = {"acoustic": 3, "image": 2, "linguistic": 4}
    data = {m: rs.randn(Bs, T, frames[m], SMALL_DIMS[m]).astype(np.float32)
            for m in mods}
    target = rs.randn(Bs, T, 1).astype(np.float32)
    mask = np.ones((Bs, T, 1), np.float32)
    mask[1, 5:] = 0.0
    denom = float(mask.sum())
    jk = jax.random.fold_in(jax.random.PRNGKey(1), 3)

    def loss_fn(p):
        pred = apply(p, {m: jnp.asarray(v) for m, v in data.items()},
                     jnp.asarray(mask), rng=jk)
        return jnp.sum((pred - target) ** 2) / denom

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    seeds = DropoutSeeds.from_key(module.dropout_sites(),
                                  prng.fold_in(prng.key(1), 3), T, "hash4")
    pred = module({m: torch.from_numpy(v) for m, v in data.items()},
                  torch.from_numpy(mask), seeds=seeds)
    loss = ((pred - torch.from_numpy(target)) ** 2).sum() / denom
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-5)
    got = {k: v.grad.numpy() for k, v in module.named_parameters()}
    want = {k: np.asarray(v) for k, v in flatten_tree(want_grads).items()}
    assert set(got) == set(want)
    assert _grad_errors(got, want) <= 1.0
    # the hash stream's seeds give another loss: the stream took effect
    module.zero_grad()
    hashed = DropoutSeeds.from_key(module.dropout_sites(),
                                   prng.fold_in(prng.key(1), 3), T)
    with torch.no_grad():
        other = module({m: torch.from_numpy(v) for m, v in data.items()},
                       torch.from_numpy(mask), seeds=hashed)
    assert float(((other - torch.from_numpy(target)) ** 2).sum() / denom
                 ) != pytest.approx(float(want_loss), rel=1e-5)


def test_hash4_engine_epoch_matches_the_jax_engine(hash4):
    """Three MFT A+V+L Adam steps of `Engine(dropout_impl="hash4")` against
    the JAX Engine under set_dropout_impl("hash4"), both from Engine(seed)'s
    weights: identical log lines, the updates within
    tests/test_torch_train.py's limits."""
    jcfg = jdefault_config("MFT", AVL, mask_mode="key_query")
    cfg = default_config("MFT", AVL, mask_mode="key_query")
    for c in (jcfg, cfg):
        object.__setattr__(c, "mod_dimension", dict(SMALL_DIMS))
    V, W = 9, 8
    rs = np.random.RandomState(5)
    data = {m: rs.randn(V, W, 3, SMALL_DIMS[m]).astype(np.float32)
            for m in AVL}
    target = rs.randn(V, W).astype(np.float32)
    lens = [8, 3, 5, 8, 2, 7, 6, 8, 4]

    class Lines(logging.Handler):
        def __init__(self):
            super().__init__()
            self.lines = []

        def emit(self, record):
            self.lines.append(record.getMessage())

    logs = {}
    for side in ("jax", "port"):
        log = logging.getLogger(f"test_torch_hash4.{side}")
        log.setLevel(logging.INFO)
        log.propagate = False
        logs[side] = Lines()
        log.addHandler(logs[side])
    eng = Engine(cfg, seed=2, device="cpu", dropout_impl="hash4",
                 logger=logging.getLogger("test_torch_hash4.port"))
    start = {k: v.numpy().copy() for k, v in eng.module.state_dict().items()}
    jeng = JEngine(jcfg, seed=2,
                   logger=logging.getLogger("test_torch_hash4.jax"))
    for side, e in (("jax", jeng), ("port", eng)):
        e.train_epoch(data, target, lens, batch_size=3,
                      rng=np.random.RandomState(0), pad_time_to=8)
    assert len(logs["port"].lines) == 5
    assert logs["port"].lines == logs["jax"].lines
    want = {k: np.asarray(v) - start[k]
            for k, v in flatten_tree(jeng.params).items()}
    got = {k: v.numpy() - start[k] for k, v in eng.module.state_dict().items()}
    diff = np.sqrt(sum(np.sum((got[k] - want[k]) ** 2) for k in want))
    norm = np.sqrt(sum(np.sum(w ** 2) for w in want.values()))
    assert diff <= 1e-2 * norm
    assert max(np.abs(got[k] - want[k]).max() for k in want) <= 1e-4
