"""The port's threefry key chain (utils/prng.py) against `jax.random`, float32
on the CPU:

  * keys, splits and fold_ins bit for bit, also along chains of depth 3;
    `random_bits`, `uniform` and `bernoulli` bit for bit at odd shapes and
    past 2**16 elements (kernel T's plain version); `hash_seed` against
    the JAX package's;
  * the counters of a data-parallel rank: a `jax.random.bernoulli` under
    `jit`, sharded over the 8 host devices' "data" axis, equals the
    unsharded draw, and each shard equals kernel T's plain version at the
    shard's counters (a batch-major site as `prng.RowKeys`, a time-major
    [T, B, 64] site as T segments), which counters from 0 do not; the
    wrapper hands the layout to the C entry that takes it;
  * `Engine(cfg, seed=s)`'s initial parameters equal the JAX
    `Engine(cfg, seed=s)`'s, drawn on each side, bit for bit, for the five
    families at reduced modality widths and for the legacy ED/AR heads
    (XLA's CPU backend rounds `uniform`'s multiply-add once, as a fused
    multiply-add; the port rounds it once too, so no ulp is allowed);
  * `DropoutSeeds.from_key` equals the seeds of each family's JAX key tree
    (`jax_reference_seeds`, built with jax) at two steps of the Engine's
    key chain, on the hash stream and, as keys, on the threefry stream;
  * a threefry training step (`DropoutSeeds.from_key(..., "threefry")`)
    of MFT A+V+L, SFT and B1-LSTM against the JAX step under
    `set_dropout_impl("threefry")`: loss within 1e-5 relative, each
    gradient within 1e-4 of its own L2 norm plus 1e-6 of the whole
    gradient's;
  * two epochs of B3-MFN A+L, `Engine(seed=1)` in both packages on the
    learnability test's synthetic SENDv1 tree, no parameter carried
    across: every epoch loss and the Valid CCC within 1e-4 relative.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from make_goldens import SMALL_DIMS

from multimodal_transformer_tpu.data import (generate_synthetic_send,
                                             load_send, window_pipeline)
from multimodal_transformer_tpu.engine import Engine as JEngine
from multimodal_transformer_tpu.models import build_model as jbuild_model
from multimodal_transformer_tpu.models import default_config as jdefault_config
from multimodal_transformer_tpu.models import legacy_lstm as jlegacy
from multimodal_transformer_tpu.ops import basic as jbasic
from multimodal_transformer_tpu.ops.pallas.encoder import dropout_seed_table
from multimodal_transformer_tpu_torch import default_config
from multimodal_transformer_tpu_torch.engine import Engine
from multimodal_transformer_tpu_torch.models import legacy_lstm
from multimodal_transformer_tpu_torch.models.families import (ENCODER_LAYERS,
                                                              build_model)
from multimodal_transformer_tpu_torch.ops.seeds import DropoutSeeds
from multimodal_transformer_tpu_torch.utils import prng
from multimodal_transformer_tpu_torch.utils.params import (export_params,
                                                           flatten_tree,
                                                           load_jax_params)
from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401

AVL = ("acoustic", "image", "linguistic")
GRAD_RTOL, GRAD_FLOOR = 1e-4, 1e-6
# (family, modalities, variant): every key tree of the five families
FAMILY_CASES = {
    "mft_avl": ("MFT", AVL, "default"),
    "mft_l": ("MFT", ("linguistic",), "default"),
    "sft_avl": ("SFT", AVL, "default"),
    "sft_a": ("SFT", ("acoustic",), "default"),
    "b1_avl": ("B1-LSTM", AVL, "default"),
    "b1_legacy": ("B1-LSTM", ("linguistic",), "legacy"),
    "b2_vl": ("B2-Trans", ("image", "linguistic"), "default"),
    "b3_al": ("B3-MFN", ("acoustic", "linguistic"), "default"),
    "b3_v": ("B3-MFN", ("image",), "default"),
}


def _jkey(k) -> np.ndarray:
    return np.asarray(jax.random.key_data(k)).astype(np.uint32)


def _configs(family, mods, variant="default"):
    jcfg = jdefault_config(family, mods, mask_mode="key_query",
                           variant=variant)
    cfg = default_config(family, mods, mask_mode="key_query", variant=variant)
    for c in (jcfg, cfg):
        object.__setattr__(c, "mod_dimension", dict(SMALL_DIMS))
    return jcfg, cfg


def test_jax_takes_the_partitionable_threefry_path():
    """prng.py follows jax_threefry_partitionable; a change of the flag
    changes jax.random's split and bits."""
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("seed", [0, 1, 42, 2 ** 31 - 1, 2 ** 32 - 1, -1, -7])
def test_key_split_fold_in_chains(seed):
    jk, pk = jax.random.PRNGKey(seed), prng.key(seed)
    assert (_jkey(jk) == pk).all()
    assert (_jkey(jax.random.split(jk, 7)) == prng.split(pk, 7)).all()
    for data in (0, 5, 2 ** 31 + 3):
        assert (_jkey(jax.random.fold_in(jk, data))
                == prng.fold_in(pk, data)).all()
    # depth 3: fold_in -> split -> fold_in, and split -> split -> split
    a = jax.random.fold_in(jax.random.split(jax.random.fold_in(jk, 3), 4)[2],
                           9)
    b = prng.fold_in(prng.split(prng.fold_in(pk, 3), 4)[2], 9)
    assert (_jkey(a) == b).all()
    c = jax.vmap(lambda k: jax.vmap(jax.random.split)(jax.random.split(k, 3)))(
        jax.random.split(jk, 2))
    assert (_jkey(c) == prng.split(prng.split(prng.split(pk, 2), 3), 2)).all()


def _chain_key(seed):
    jk = jax.random.fold_in(jax.random.split(jax.random.PRNGKey(seed), 3)[1],
                            11)
    return jk, prng.fold_in(prng.split(prng.key(seed), 3)[1], 11)


# odd shapes, and past 2**16 elements
SHAPES = [(7,), (3, 5, 11), (65537,), (2, 3, 41, 277)]


@pytest.mark.parametrize("shape", SHAPES)
def test_bits_uniform_bernoulli_equal_jax(shape):
    jk, pk = _chain_key(5)
    want = np.asarray(jax.random.bits(jk, shape, jnp.uint32))
    got = prng.random_bits(pk, shape, "cpu").numpy().view(np.uint32)
    assert got.shape == shape and (got == want).all()
    for lo, hi in ((-1 / np.sqrt(300), 1 / np.sqrt(300)), (0.0, 1.0)):
        want = np.asarray(jax.random.uniform(jk, shape, jnp.float32, lo, hi))
        got = prng.uniform(pk, shape, lo, hi, "cpu").numpy()
        assert (got.view(np.int32) == want.view(np.int32)).all(), (lo, hi)
    for p in (0.9, 0.7, 0.5):  # the keep rates of p = 0.1, 0.3, 0.5
        want = np.asarray(jax.random.bernoulli(jk, p, shape))
        got = prng.bernoulli(pk, p, shape, "cpu").numpy()
        assert (got == want).all(), p


def test_stacked_keys_draw_each_key():
    """A [K, 2] stack of keys draws each key's bits (kernel T's batched
    call, the MFN's gamma masks)."""
    jk, pk = _chain_key(8)
    keys = prng.split(pk, 6)
    got = prng.bernoulli(keys.reshape(3, 2, 2), 0.8, (5, 13), "cpu")
    for i, k in enumerate(jax.random.split(jk, 6)):
        want = np.asarray(jax.random.bernoulli(k, 0.8, (5, 13)))
        assert (got.reshape(6, 5, 13)[i].numpy() == want).all()


@pytest.mark.parametrize("mode", ["bits", "keep"])
def test_kernel_t_launches_once_for_each_block_of_keys(monkeypatch, mode):
    """On the card the wrapper hands kernel T's C entry at most MAX_KEYS
    keys a launch, with the output rows of that block, and counts each
    launch (1,088 keys: 480, 480, 128), here through a stand-in library
    on a CPU tensor, the kernel itself running only on the card."""
    import contextlib
    import ctypes
    import types

    from multimodal_transformer_tpu_torch.ops.cuda import _build
    from multimodal_transformer_tpu_torch.ops.cuda import threefry

    calls = []

    class Lib:
        @staticmethod
        def mmtx_threefry(keys, K, n, mode, p, out, stream, start, seg_len,
                          seg_stride):
            first = ctypes.cast(keys, ctypes.POINTER(ctypes.c_uint32))
            calls.append((K, out, (first[0], first[1]),
                          (start, seg_len, seg_stride)))
            return 0

    monkeypatch.setattr(threefry, "use_kernel", lambda t: True)
    monkeypatch.setattr(_build, "load", lambda *a, **k: Lib)
    monkeypatch.setattr(torch.cuda, "device", contextlib.nullcontext)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    keys = prng.split(prng.split(prng.key(4), 544), 2).reshape(-1, 2)
    n = 64
    threefry.reset_launches()
    if mode == "bits":
        out, size = threefry.threefry_bits(keys, n, "cpu"), 4
    else:
        out, size = threefry.threefry_keep_mask(keys, n, 0.9, "cpu"), 1
    assert threefry.launches == 3
    assert [c[0] for c in calls] == [480, 480, 128]
    assert [c[1] - out.data_ptr() for c in calls] == [0, 480 * n * size,
                                                       960 * n * size]
    assert [c[2] for c in calls] == [tuple(keys[k]) for k in (0, 480, 960)]
    assert [c[3] for c in calls] == [(0, n, n)] * 3


@pytest.mark.parametrize("layout,want", [
    (None, (0, 192, 192)),
    ((4096, 64, 256), (4096, 64, 256)),
    ((4096, 64, 64), (4096, 192, 192)),    # contiguous: one segment
    ((4096, 500, 7), (4096, 192, 192)),    # a segment longer than n
])
def test_kernel_t_counters_reach_the_c_entry(monkeypatch, layout, want):
    """`mmtx_threefry` takes (start, seg_len, seg_stride), a layout whose
    counters are contiguous as one segment of n, one launch a block of
    MAX_KEYS keys (stand-in library)."""
    import contextlib
    import types

    from multimodal_transformer_tpu_torch.ops.cuda import _build
    from multimodal_transformer_tpu_torch.ops.cuda import threefry

    calls = []

    class Lib:
        @staticmethod
        def mmtx_threefry(keys, K, n, mode, p, out, stream, start, seg_len,
                          seg_stride):
            calls.append((K, n, mode, start, seg_len, seg_stride))
            return 0

    monkeypatch.setattr(threefry, "use_kernel", lambda t: True)
    monkeypatch.setattr(_build, "load", lambda *a, **k: Lib)
    monkeypatch.setattr(torch.cuda, "device", contextlib.nullcontext)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    keys = prng.split(prng.key(4), 500)
    n = 192
    kw = {} if layout is None else dict(zip(("start", "seg_len",
                                             "seg_stride"), layout))
    threefry.reset_launches()
    threefry.threefry_keep_mask(keys, n, 0.9, "cpu", **kw)
    threefry.threefry_bits(keys, n, "cpu", **kw)
    assert threefry.launches == 4
    assert [c[:3] for c in calls] == [(480, n, 1), (20, n, 1), (480, n, 0),
                                      (20, n, 0)]
    assert all(c[3:] == want for c in calls)


def test_counters_and_row_keys_refuse_what_they_cannot_draw():
    pk = prng.key(3)
    with pytest.raises(ValueError, match="counters"):
        prng.bernoulli(pk, 0.5, (4,), "cpu", seg_len=0)
    with pytest.raises(ValueError, match="counters"):
        prng.random_bits(pk, (4,), "cpu", start=-1)
    rk = prng.RowKeys(pk, 2, 4)
    assert prng.is_keys(rk) and prng.is_keys(prng.RowKeys(
        prng.split(pk, 3), 0, 2)[1])
    with pytest.raises(ValueError, match="RowKeys"):
        prng.bernoulli(rk, 0.5, (2, 3), "cpu", start=6)
    with pytest.raises(ValueError, match="rows"):
        prng.bernoulli(rk, 0.5, (3, 3), "cpu")  # rows [2, 5) of 4


# ------------------------------------------- a rank's counters of a draw

SHARDED = {  # (global shape, sharded axis): the two layouts of dropout sites
    "batch_major": ((16, 2, 5, 5), 0),   # [B, h, T, T]
    "time_major": ((3, 16, 64), 1),      # the MFN head's [T, B, 64]
}


@pytest.mark.parametrize("site", list(SHARDED))
def test_sharded_bernoulli_is_the_global_draw_at_the_rank_counters(site):
    """What the JAX mesh Engine's dropout does: `jax.random.bernoulli`
    partitioned over "data" draws the global mask bit for bit; kernel T's
    plain version at each shard's counters gives that shard."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    shape, axis = SHARDED[site]
    devices = jax.devices()
    assert len(devices) == 8
    mesh = Mesh(np.array(devices), ("data",))
    spec = PartitionSpec(*([None] * axis + ["data"]))
    jk, pk = _chain_key(12)
    keep = 0.8
    want = np.asarray(jax.random.bernoulli(jk, keep, shape))
    sharded = jax.jit(lambda k: jax.random.bernoulli(k, keep, shape),
                      out_shardings=NamedSharding(mesh, spec))(jk)
    assert len(sharded.addressable_shards) == 8
    assert (np.asarray(sharded) == want).all()
    rows = shape[axis]
    local = rows // 8
    per = math.prod(shape[axis + 1:])  # elements of a row at the axis
    n = math.prod(shape) // 8
    for shard in sharded.addressable_shards:
        r0 = shard.index[axis].start
        mine = np.asarray(shard.data)
        if site == "batch_major":
            got = prng.keep_mask_plain(pk[None], n, keep, "cpu",
                                       start=r0 * per)
            via_rows = prng.bernoulli(prng.RowKeys(pk, r0, rows), keep,
                                      mine.shape, "cpu")
            assert (via_rows.numpy() == mine).all()
        else:
            got = prng.keep_mask_plain(pk[None], n, keep, "cpu",
                                       start=r0 * per, seg_len=local * per,
                                       seg_stride=rows * per)
        assert (got.view(mine.shape).numpy() == mine).all(), r0
        from_zero = prng.keep_mask_plain(pk[None], n, keep, "cpu")
        if r0 > 0:  # the negative control: counters from 0 differ
            assert not (from_zero.view(mine.shape).numpy() == mine).all()


def test_hash_seed_equals_jax():
    jk, pk = _chain_key(2)
    jkeys = jax.random.split(jk, 50)
    want = np.array([int(np.asarray(jbasic.hash_seed(k)).astype(np.uint32))
                     for k in jkeys])
    assert (prng.hash_seed(prng.split(pk, 50)) == want).all()


# ------------------------------------------------------ initial weights


def _assert_tree_equal(got: dict, want: dict):
    want = {k: np.asarray(v) for k, v in flatten_tree(want).items()}
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        assert (g.view(np.int32) == w.astype(np.float32).view(np.int32)).all(), k


@pytest.mark.parametrize("name", ["mft_avl", "sft_avl", "b1_avl", "b2_vl",
                                  "b3_al"])
def test_engine_initial_weights_equal_jax(name):
    family, mods, variant = FAMILY_CASES[name]
    jcfg, cfg = _configs(family, mods, variant)
    want = JEngine(jcfg, seed=3).params
    got = Engine(cfg, seed=3, device="cpu").module.state_dict()
    _assert_tree_equal({k: v.numpy() for k, v in got.items()}, want)


@pytest.mark.parametrize("head", ["ed", "ar"])
def test_legacy_heads_initial_weights_equal_jax(head):
    we = 44
    jinit = {"ed": jlegacy.multi_ed_lstm_init,
             "ar": jlegacy.multi_ar_lstm_init}[head]
    init, cls = {"ed": (legacy_lstm.multi_ed_lstm_init,
                        legacy_lstm.MultiEDLSTM),
                 "ar": (legacy_lstm.multi_ar_lstm_init,
                        legacy_lstm.MultiARLSTM)}[head]
    module = load_jax_params(cls(we), init(prng.key(4), we))
    _assert_tree_equal({k: v.numpy() for k, v in module.state_dict().items()},
                       jinit(jax.random.PRNGKey(4), we))


# ------------------------------------------------------------ step seeds


def _u32(a) -> int:
    return int(np.asarray(a).astype(np.uint32))


def _table(key) -> torch.Tensor:
    return torch.from_numpy(np.asarray(dropout_seed_table(
        key, ENCODER_LAYERS)).view(np.uint32).astype(np.int64))


def _mfn_seeds(key, T: int):
    steps = jax.random.split(key, T)
    sub = jax.vmap(lambda k: jax.random.split(k, 2))(steps)
    mfn = jax.vmap(lambda ks: jnp.stack([jbasic.hash_seed(ks[0]),
                                         jbasic.hash_seed(ks[1])]))(sub)
    out = _u32(jbasic.hash_seed(jax.random.fold_in(key, 7)))
    return torch.from_numpy(np.asarray(mfn).astype(np.int64)), out


def jax_reference_seeds(key, cfg, T: int) -> DropoutSeeds:
    """The per-site hash seeds that the family's JAX apply draws from `key`
    (`_split_rng` trees of families.py; frontend.py, heads.py,
    attention.py, mfn_core.py), built with jax."""
    mods, family = cfg.modalities, cfg.family
    multi = len(mods) > 1
    r_front, r_head = jax.random.split(key)
    front = {m: _u32(jbasic.hash_seed(k))
             for m, k in zip(mods, jax.random.split(r_front, len(mods)))}
    if family == "MFT" and multi:
        rngs = jax.random.split(r_head, len(mods) + 1)
        encoder = {f"transformer_{m}": _table(rngs[i])
                   for i, m in enumerate(mods)}
        return DropoutSeeds(front, encoder, *_mfn_seeds(rngs[-1], T))
    if family == "B3-MFN" and multi:
        return DropoutSeeds(front, {}, *_mfn_seeds(r_head, T))
    if family == "B1-LSTM":
        embed, decoder = jax.random.split(r_head, 2)
        return DropoutSeeds(front, embed=_u32(jbasic.hash_seed(embed)),
                            decoder=_u32(jbasic.hash_seed(decoder)))
    if family == "B2-Trans":
        return DropoutSeeds(front, {"encoder": _table(
            jax.random.split(r_head, 1)[0])})
    rngs = jax.random.split(r_head, 3)
    embed = (_u32(jbasic.hash_seed(rngs[0])) if family == "SFT" and multi
             else None)
    return DropoutSeeds(front, {"encoder": _table(rngs[1])}, embed=embed)


def _seeds_equal(got: DropoutSeeds, want: DropoutSeeds):
    assert got.front == want.front
    assert set(got.encoder) == set(want.encoder)
    for k in want.encoder:
        assert torch.equal(got.encoder[k], want.encoder[k]), k
    assert (got.mfn is None) == (want.mfn is None)
    if want.mfn is not None:
        assert torch.equal(got.mfn, want.mfn)
    assert (got.out, got.embed, got.decoder) == (want.out, want.embed,
                                                 want.decoder)


@pytest.mark.parametrize("name", sorted(FAMILY_CASES))
def test_step_seeds_equal_the_jax_key_tree(name):
    """The Engine's step key fold_in(PRNGKey(epoch), batch) at two steps,
    split along the family's key tree: hashed, the JAX apply's seeds; on
    the threefry stream, its keys (each hashes to the same seed)."""
    family, mods, variant = FAMILY_CASES[name]
    _, cfg = _configs(family, mods, variant)
    sites, T = build_model(cfg, device="meta").dropout_sites(), 9
    for epoch, batch in ((1, 0), (3, 2)):
        jk = jax.random.fold_in(jax.random.PRNGKey(epoch), batch)
        pk = prng.fold_in(prng.key(epoch), batch)
        want = jax_reference_seeds(jk, cfg, T)
        _seeds_equal(DropoutSeeds.from_key(sites, pk, T), want)
        keys = DropoutSeeds.from_key(sites, pk, T, "threefry")
        hashed = DropoutSeeds(
            {m: int(prng.hash_seed(k)) for m, k in keys.front.items()},
            {n: torch.from_numpy(prng.hash_seed(t).astype(np.int64))
             for n, t in keys.encoder.items()},
            None if keys.mfn is None else torch.from_numpy(
                prng.hash_seed(keys.mfn).astype(np.int64)),
            *(None if k is None else int(prng.hash_seed(k))
              for k in (keys.out, keys.embed, keys.decoder)))
        _seeds_equal(hashed, want)


def test_legacy_head_seeds_equal_its_key_tree():
    jk = jax.random.fold_in(jax.random.PRNGKey(2), 1)
    want = _u32(jbasic.hash_seed(jax.random.split(jk, 1)[0]))
    sites = legacy_lstm.MultiARLSTM(20).dropout_sites()
    got = DropoutSeeds.from_key(sites, prng.fold_in(prng.key(2), 1), 5)
    assert got.embed == want and got.front == {}


# ------------------------------------------------- threefry training step


@pytest.fixture
def threefry_dropout():
    jbasic.set_dropout_impl("threefry")
    yield
    jbasic.set_dropout_impl(None)


def _grad_errors(got: dict, want: dict) -> float:
    total = np.sqrt(sum(float(np.sum(np.square(v, dtype=np.float64)))
                        for v in want.values()))
    worst = 0.0
    for k, w in want.items():
        diff = np.linalg.norm((got[k] - w).ravel())
        limit = GRAD_RTOL * np.linalg.norm(w.ravel()) + GRAD_FLOOR * total
        worst = max(worst, diff / limit)
    return worst


@pytest.mark.parametrize("name", ["mft_avl", "sft_avl", "b1_avl"])
def test_threefry_train_step_matches_jax(name, threefry_dropout):
    family, mods, variant = FAMILY_CASES[name]
    jcfg, cfg = _configs(family, mods, variant)
    module = build_model(cfg, seed=6)
    params = export_params(module)
    _, apply = jbuild_model(jcfg)
    B, T = 2, 8
    rs = np.random.RandomState(4)
    frames = {"acoustic": 3, "image": 2, "linguistic": 4}
    data = {m: rs.randn(B, T, frames[m], SMALL_DIMS[m]).astype(np.float32)
            for m in mods}
    target = rs.randn(B, T, 1).astype(np.float32)
    mask = np.ones((B, T, 1), np.float32)
    mask[1, 5:] = 0.0
    denom = float(mask.sum())
    jk = jax.random.fold_in(jax.random.PRNGKey(1), 3)

    def loss_fn(p):
        pred = apply(p, {m: jnp.asarray(v) for m, v in data.items()},
                     jnp.asarray(mask), rng=jk)
        return jnp.sum((pred - target) ** 2) / denom

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    seeds = DropoutSeeds.from_key(module.dropout_sites(),
                                  prng.fold_in(prng.key(1), 3), T, "threefry")
    pred = module({m: torch.from_numpy(v) for m, v in data.items()},
                  torch.from_numpy(mask), seeds=seeds)
    loss = ((pred - torch.from_numpy(target)) ** 2).sum() / denom
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-5)
    got = {k: v.grad.numpy() for k, v in module.named_parameters()}
    want = {k: np.asarray(v) for k, v in flatten_tree(want_grads).items()}
    assert set(got) == set(want)
    assert _grad_errors(got, want) <= 1.0


# -------------------------------------------- two epochs, nothing carried

LEARN_DIMS = {"linguistic": 16, "emotient": 20, "image": 12, "acoustic": 10}
# measured on the CPU: epoch losses 1.25e-6 and 7.01e-6, Valid CCC 1.58e-5
# relative apart (float32 sums in another order, grown over 4 Adam steps)
TWO_EPOCH_RTOL = 1e-4


def test_two_epochs_of_b3_mfn_match_the_jax_engine(tmp_path):
    generate_synthetic_send(str(tmp_path), {"Train": 8, "Valid": 4},
                            duration_s=30.0, dims=LEARN_DIMS, seed=0)
    mods = ("acoustic", "linguistic")
    jcfg = jdefault_config("B3-MFN", mods)
    cfg = default_config("B3-MFN", mods)
    for c in (jcfg, cfg):
        object.__setattr__(c, "mod_dimension", dict(LEARN_DIMS))

    def prep(subset):
        ds = load_send(list(mods), str(tmp_path), subset)
        return window_pipeline(ds, jcfg.window_size, mods, jcfg.mod_dimension)

    tx, ty, tl = prep("Train")
    vx, vy, vl = prep("Valid")
    runs = {}
    for side, eng in (("jax", JEngine(jcfg, lr=2e-3, seed=1)),
                      ("port", Engine(cfg, lr=2e-3, seed=1, device="cpu"))):
        rng = np.random.RandomState(1)
        losses = [eng.train_epoch(tx, ty, tl, batch_size=4, rng=rng)
                  for _ in range(2)]
        stats = eng.evaluate_per_video(vx, vy, vl)[4]
        runs[side] = losses + [stats["ccc"]]
    np.testing.assert_allclose(runs["port"], runs["jax"], rtol=TWO_EPOCH_RTOL)
