"""The port's rbg keys (utils/prng.py, `key(seed, "rbg")`) and kernel P's
plain version against `jax.random` under `jax_default_prng_impl="rbg"`,
the JAX CLI's `--fast_rng`, on the CPU:

  * keys, splits, fold_ins and `hash_seed` bit for bit, along chains;
  * `philox_bits_plain` against `jax.random.bits` at n in {1, 3, 4, 12,
    4097} and a [32, 8, 160, 160] draw, and against
    `lax.rng_bit_generator` at keys whose counter carries into its high
    half; a counter layout (start, segments) against the global draw's
    elements; `uniform` and `bernoulli` at odd shapes;
  * a `jax.random.bernoulli` under `jit`, sharded over the 8 host devices'
    "data" axis, equals the unsharded draw, and each shard equals kernel
    P's plain version at the shard's elements (the JAX mesh Engine's
    partitioned draw is the one-device draw);
  * kernel P's wrapper: one launch a block of 240 keys, the layout handed
    to the C entry (a stand-in library);
  * `Engine(cfg, seed, prng_impl="rbg")`'s initial weights equal the JAX
    Engine's under rbg, bit for bit; the step seeds equal the JAX key
    tree's; a "threefry"-dropout training step under rbg keys (kernel P's
    masks at every site) against `jax.value_and_grad` of the JAX apply;
  * one `--fast_rng` epoch of the port's CLI against the JAX CLI's (B3-MFN
    A+L), on the hash and the threefry dropout streams: the batch and epoch
    losses and the Valid CCC within 1e-4 relative.
"""

import contextlib
import math
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from make_goldens import SMALL_DIMS

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import train as jcli  # noqa: E402
from multimodal_transformer_tpu.data import generate_synthetic_send  # noqa: E402
from multimodal_transformer_tpu.engine import Engine as JEngine  # noqa: E402
from multimodal_transformer_tpu.models import build_model as jbuild_model  # noqa: E402
from multimodal_transformer_tpu.models import default_config as jdefault_config  # noqa: E402
from multimodal_transformer_tpu.ops import basic as jbasic  # noqa: E402
from multimodal_transformer_tpu_torch import build_model, default_config  # noqa: E402
from multimodal_transformer_tpu_torch import train as cli  # noqa: E402
from multimodal_transformer_tpu_torch.engine import Engine  # noqa: E402
from multimodal_transformer_tpu_torch.ops.seeds import DropoutSeeds  # noqa: E402
from multimodal_transformer_tpu_torch.utils import prng  # noqa: E402
from multimodal_transformer_tpu_torch.utils.params import (  # noqa: E402
    export_params, flatten_tree)
from test_torch_prng import (_assert_tree_equal, _grad_errors,  # noqa: E402
                             _seeds_equal, jax_reference_seeds)
from torch_threads import one_torch_thread as _one_torch_thread  # noqa: E402,F401

AVL = ("acoustic", "image", "linguistic")


@contextlib.contextmanager
def rbg_keys():
    """JAX's keys under the rbg implementation, the default restored
    after."""
    old = jax.config.jax_default_prng_impl
    jax.config.update("jax_default_prng_impl", "rbg")
    try:
        yield
    finally:
        jax.config.update("jax_default_prng_impl", old)


def _kd(k) -> np.ndarray:
    return np.asarray(jax.random.key_data(k)).astype(np.uint32)


def _configs(family, mods):
    jcfg = jdefault_config(family, mods, mask_mode="key_query")
    cfg = default_config(family, mods, mask_mode="key_query")
    for c in (jcfg, cfg):
        object.__setattr__(c, "mod_dimension", dict(SMALL_DIMS))
    return jcfg, cfg


@pytest.mark.parametrize("seed", [0, 1, 42, 2 ** 32 - 1, -7])
def test_rbg_keys_splits_fold_ins_and_hash_seeds_equal_jax(seed):
    with rbg_keys():
        jk, pk = jax.random.PRNGKey(seed), prng.key(seed, "rbg")
        assert pk.shape == (4,) and (_kd(jk) == pk).all()
        assert prng.impl_of(pk) == "rbg" and prng.is_keys(pk)
        assert (_kd(jax.random.split(jk, 7)) == prng.split(pk, 7)).all()
        for data in (0, 5, 2 ** 31 + 3):
            assert (_kd(jax.random.fold_in(jk, data))
                    == prng.fold_in(pk, data)).all()
        a = jax.random.fold_in(
            jax.random.split(jax.random.fold_in(jk, 3), 4)[2], 9)
        b = prng.fold_in(prng.split(prng.fold_in(pk, 3), 4)[2], 9)
        assert (_kd(a) == b).all()
        c = jax.vmap(jax.random.split)(jax.random.split(jk, 3))
        assert (_kd(c) == prng.split(prng.split(pk, 3), 2)).all()
        keys = jax.random.split(a, 20)
        want = [int(np.asarray(jbasic.hash_seed(k)).astype(np.uint32))
                for k in keys]
        assert (prng.hash_seed(_kd(keys)) == want).all()


def _chain_key(seed):
    with rbg_keys():
        jk = jax.random.fold_in(
            jax.random.split(jax.random.PRNGKey(seed), 3)[1], 11)
    return jk, prng.fold_in(prng.split(prng.key(seed, "rbg"), 3)[1], 11)


@pytest.mark.parametrize("shape", [(1,), (3,), (4,), (12,), (4097,),
                                   (32, 8, 160, 160)])
def test_philox_bits_equal_jax(shape):
    jk, pk = _chain_key(5)
    with rbg_keys():
        want = np.asarray(jax.random.bits(jk, shape, jnp.uint32))
    got = prng.philox_bits_plain(pk[None], math.prod(shape))
    assert (got.numpy().astype(np.uint32).reshape(shape) == want).all()


@pytest.mark.parametrize("key", [[1, 2, 3, 4], [9, 8, 0xFFFFFFF0, 0xFFFFFFFF],
                                 [0xFFFFFFFF] * 4])
def test_philox_counter_carries_and_layouts(key):
    """XLA's Philox at keys whose 64-bit counter wraps within the draw (the
    carry into its high half), and a layout of elements against the
    global draw's."""
    key = np.array(key, np.uint32)
    n = 4099
    want = np.asarray(jax.lax.rng_bit_generator(jnp.asarray(key), (n,),
                                                dtype=jnp.uint32)[1])
    full = prng.philox_bits_plain(key[None], n)[0].numpy()
    assert (full.astype(np.uint32) == want).all()
    for start, seg_len, stride in ((37, 60, 333), (1, 5, 7), (6, 4096, 0)):
        m = 600 if seg_len < 4096 else 8
        part = prng.philox_bits_plain(key[None], m, start=start,
                                      seg_len=seg_len, seg_stride=stride)
        j = np.arange(m)
        idx = start + j // seg_len * stride + j % seg_len
        assert (part[0].numpy() == full[idx]).all(), (start, seg_len)


@pytest.mark.parametrize("shape", [(7,), (3, 5, 11), (65537,), (2, 3, 41, 277)])
def test_uniform_and_bernoulli_equal_jax(shape):
    jk, pk = _chain_key(8)
    with rbg_keys():
        for lo, hi in ((-1 / np.sqrt(300), 1 / np.sqrt(300)), (0.0, 1.0)):
            want = np.asarray(jax.random.uniform(jk, shape, jnp.float32, lo,
                                                 hi))
            got = prng.uniform(pk, shape, lo, hi, "cpu").numpy()
            assert (got.view(np.int32) == want.view(np.int32)).all()
        for p in (0.9, 0.8, 0.5):
            want = np.asarray(jax.random.bernoulli(jk, p, shape))
            assert (prng.bernoulli(pk, p, shape, "cpu").numpy()
                    == want).all(), p
        keys = jax.random.split(jk, 3)
        got = prng.bernoulli(prng.split(pk, 3), 0.8, shape[-1:], "cpu")
        for i, k in enumerate(keys):  # a stack of keys draws each key's
            want = np.asarray(jax.random.bernoulli(k, 0.8, shape[-1:]))
            assert (got[i].numpy() == want).all()


SHARDED = {"batch_major": ((16, 2, 5, 5), 0), "time_major": ((3, 16, 64), 1)}


@pytest.mark.parametrize("site", list(SHARDED))
def test_sharded_rbg_bernoulli_is_the_global_draw_at_the_rank_elements(site):
    """The JAX mesh Engine's dropout under rbg: `jax.random.bernoulli`
    partitioned over "data" draws the one-device mask bit for bit, and
    each shard is kernel P's plain version at the shard's elements (a
    batch-major site as `prng.RowKeys`, a time-major one as T
    segments)."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    shape, axis = SHARDED[site]
    mesh = Mesh(np.array(jax.devices()), ("data",))
    spec = PartitionSpec(*([None] * axis + ["data"]))
    jk, pk = _chain_key(12)
    keep = 0.8
    with rbg_keys():
        want = np.asarray(jax.random.bernoulli(jk, keep, shape))
        sharded = jax.jit(lambda k: jax.random.bernoulli(k, keep, shape),
                          out_shardings=NamedSharding(mesh, spec))(jk)
        assert len(sharded.addressable_shards) == 8
        assert (np.asarray(sharded) == want).all()
        shards = [(s.index[axis].start, np.asarray(s.data))
                  for s in sharded.addressable_shards]
    rows = shape[axis]
    local, per = rows // 8, math.prod(shape[axis + 1:])
    n = math.prod(shape) // 8
    for r0, mine in shards:
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
        if r0 > 0:  # the negative control: elements from 0 differ
            from_zero = prng.keep_mask_plain(pk[None], n, keep, "cpu")
            assert not (from_zero.view(mine.shape).numpy() == mine).all()


@pytest.mark.parametrize("mode", ["bits", "keep"])
def test_kernel_p_launches_once_for_each_block_of_keys(monkeypatch, mode):
    """On the card the wrapper hands kernel P's C entry at most MAX_KEYS
    keys a launch, with the output rows of that block and the layout, and
    counts each launch (544 keys: 240, 240, 64), here through a stand-in
    library on a CPU tensor."""
    import contextlib as cl
    import ctypes
    import types

    from multimodal_transformer_tpu_torch.ops.cuda import _build, philox

    calls = []

    class Lib:
        @staticmethod
        def mmtx_philox(keys, K, n, mode, p, out, stream, start, seg_len,
                        seg_stride):
            first = ctypes.cast(keys, ctypes.POINTER(ctypes.c_uint32))
            calls.append((K, out, tuple(first[i] for i in range(4)),
                          (start, seg_len, seg_stride)))
            return 0

    monkeypatch.setattr(philox, "use_kernel", lambda t: True)
    monkeypatch.setattr(_build, "load", lambda *a, **k: Lib)
    monkeypatch.setattr(torch.cuda, "device", cl.nullcontext)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    keys = prng.split(prng.split(prng.key(4, "rbg"), 272), 2).reshape(-1, 4)
    n = 64
    philox.reset_launches()
    layout = dict(start=4096, seg_len=16, seg_stride=48)
    if mode == "bits":
        out, size = philox.philox_bits(keys, n, "cpu", **layout), 4
    else:
        out, size = philox.philox_keep_mask(keys, n, 0.9, "cpu", **layout), 1
    assert philox.launches == 3
    assert [c[0] for c in calls] == [240, 240, 64]
    assert [c[1] - out.data_ptr() for c in calls] == [0, 240 * n * size,
                                                       480 * n * size]
    assert [c[2] for c in calls] == [tuple(keys[k]) for k in (0, 240, 480)]
    assert [c[3] for c in calls] == [(4096, 16, 48)] * 3
    with pytest.raises(ValueError, match="rbg keys"):
        philox.philox_bits(prng.split(prng.key(4), 3), n, "cpu")


# ----------------------------------------------------- weights and steps

@pytest.mark.parametrize("family,mods", [("MFT", AVL), ("B3-MFN", AVL),
                                         ("B1-LSTM", AVL)])
def test_engine_initial_weights_equal_jax_under_rbg(family, mods):
    jcfg, cfg = _configs(family, mods)
    with rbg_keys():
        want = JEngine(jcfg, seed=3).params
    got = Engine(cfg, seed=3, device="cpu", prng_impl="rbg")
    _assert_tree_equal({k: v.numpy()
                        for k, v in got.module.state_dict().items()}, want)
    threefry = Engine(cfg, seed=3, device="cpu").module.state_dict()
    assert not all(torch.equal(v, threefry[k])
                   for k, v in got.module.state_dict().items())


@pytest.mark.parametrize("family,mods", [("MFT", AVL), ("B1-LSTM", AVL),
                                         ("SFT", AVL)])
def test_step_seeds_equal_the_jax_rbg_key_tree(family, mods):
    """The Engine's step key under rbg, fold_in(PRNGKey(epoch), batch),
    split along the family's key tree and hashed: the JAX apply's seeds
    under rbg keys."""
    _, cfg = _configs(family, mods)
    sites, T = build_model(cfg, device="meta").dropout_sites(), 9
    eng = Engine(cfg, seed=1, device="cpu", prng_impl="rbg")
    with rbg_keys():
        for epoch, batch in ((1, 0), (3, 2)):
            jk = jax.random.fold_in(jax.random.PRNGKey(epoch), batch)
            want = jax_reference_seeds(jk, cfg, T)
            pk = prng.fold_in(prng.key(epoch, "rbg"), batch)
            _seeds_equal(DropoutSeeds.from_key(sites, pk, T), want)
            eng._epoch, eng._batch = epoch, batch
            _seeds_equal(eng.step_seeds(T), want)


def test_rbg_threefry_train_step_matches_jax():
    """MFT A+V+L under rbg keys on the "threefry" dropout (bernoulli of
    every site's rbg key: kernel P's plain version) against
    `jax.value_and_grad` of the JAX apply, test_torch_prng's limits."""
    jcfg, cfg = _configs("MFT", AVL)
    module = build_model(cfg, seed=6, prng_impl="rbg")
    params = export_params(module)
    _, apply = jbuild_model(jcfg)
    B, T = 2, 8
    rs = np.random.RandomState(4)
    frames = {"acoustic": 3, "image": 2, "linguistic": 4}
    data = {m: rs.randn(B, T, frames[m], SMALL_DIMS[m]).astype(np.float32)
            for m in AVL}
    target = rs.randn(B, T, 1).astype(np.float32)
    mask = np.ones((B, T, 1), np.float32)
    mask[1, 5:] = 0.0
    denom = float(mask.sum())
    jbasic.set_dropout_impl("threefry")
    try:
        with rbg_keys():
            jk = jax.random.fold_in(jax.random.PRNGKey(1), 3)

            def loss_fn(p):
                pred = apply(p, {m: jnp.asarray(v) for m, v in data.items()},
                             jnp.asarray(mask), rng=jk)
                return jnp.sum((pred - target) ** 2) / denom

            want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(
                params)
    finally:
        jbasic.set_dropout_impl(None)
    seeds = DropoutSeeds.from_key(module.dropout_sites(), prng.fold_in(
        prng.key(1, "rbg"), 3), T, "threefry")
    assert seeds.threefry() and seeds.mfn.shape == (T, 2, 4)
    pred = module({m: torch.from_numpy(v) for m, v in data.items()},
                  torch.from_numpy(mask), seeds=seeds)
    loss = ((pred - torch.from_numpy(target)) ** 2).sum() / denom
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-5)
    got = {k: v.grad.numpy() for k, v in module.named_parameters()}
    want = {k: np.asarray(v) for k, v in flatten_tree(want_grads).items()}
    assert set(got) == set(want)
    assert _grad_errors(got, want) <= 1.0


# ------------------------------------------------------------- the CLI

CLI_RTOL = 1e-4  # tests/test_torch_prng.py's two-epoch B3-MFN limit


@pytest.fixture(scope="module")
def send_tree(tmp_path_factory):
    d = tmp_path_factory.mktemp("rbg_cli")
    generate_synthetic_send(str(d / "SENDv1-data"), {"Train": 3, "Valid": 2,
                                                     "Test": 2},
                            duration_s=18.0, seed=7)
    return d


def _losses(log: str) -> list:
    return [float(v) for v in re.findall(
        r"(?:Batch: +\d+|Epoch: \d+)\tLoss: ([-\d.]+)", log)]


@pytest.mark.parametrize("impl", ["hash", "threefry"])
def test_fast_rng_epoch_equals_the_jax_cli(send_tree, impl):
    """`--fast_rng` in both CLIs, B3-MFN A+L, one epoch: the logged batch
    and epoch losses and the best Valid CCC."""
    out = {}
    for side, main, parser in (("jax", jcli.main, jcli.build_arg_parser),
                               ("port", cli.main, cli.build_arg_parser)):
        d = send_tree / f"{side}_{impl}"
        args = ["--data_dir", str(send_tree / "SENDv1-data"),
                "--save_dir", str(d / "ModelSave"),
                "--pred_save_dir", str(d / "PredSave"),
                "--perf_save_dir", str(d / "PerfSave"),
                "--log_file", str(d / "train.log"), "--family", "B3-MFN",
                "--comb", "AL", "--epochs", "1", "--fast_rng",
                "--dropout_impl", impl]
        if side == "port":
            args += ["--device", "cpu"]
        d.mkdir()
        old = jax.config.jax_default_prng_impl
        try:
            best = main(parser().parse_args(args))
        finally:
            jax.config.update("jax_default_prng_impl", old)
            jbasic.set_dropout_impl(None)
        out[side] = (_losses((d / "train.log").read_text()), best)
    (jl, jbest), (pl, pbest) = out["jax"], out["port"]
    assert len(jl) >= 2 and len(pl) == len(jl)
    np.testing.assert_allclose(pl, jl, rtol=CLI_RTOL)
    assert pbest == pytest.approx(jbest, rel=CLI_RTOL)
