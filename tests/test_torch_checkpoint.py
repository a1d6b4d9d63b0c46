"""The port's checkpoints, resume, NaN guard and device-resident epochs,
on the CPU:

  * a `.pth` written by the port (reference key layout) reads back into the
    same configuration and state_dict and equals the JAX `export_state_dict`
    of the same tree, for every family (B1 legacy and a 44-wide acoustic
    embed detected from the weights); the JAX `convert_pth` reads it into
    the same tree (SFT A, B1 legacy);
  * the port's msgpack decoder gives what flax's `msgpack_restore` gives on
    a JAX `save_checkpoint` `.ckpt`, a `save_train_state` `.state` in both
    Adam layouts, and every msgpack format they use; it refuses a chunked
    array;
  * save at epoch 1, restore into a fresh Engine, train on: bit-identical
    to a run that never stopped; an epoch through the prefetcher is
    bit-identical to one without; a resident epoch is bit-identical to the
    host epoch at the split's full length, and its filler rows add nothing;
  * a JAX `.state` (tree and flat Adam layout) restored into the port
    continues the JAX trajectory for two steps (B2-Trans V+L at small
    modality widths, seeds from the JAX keys): parameters within 1e-5
    relative L2, losses within 1e-5;
  * NanGuard raises with the names of the bad parameters.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization
from make_goldens import SMALL_DIMS
from test_torch_train import jax_family_seeds

from multimodal_transformer_tpu.engine import checkpoint as jcheckpoint
from multimodal_transformer_tpu.engine import convert as jconvert
from multimodal_transformer_tpu.engine import optim as joptim
from multimodal_transformer_tpu.engine import train_engine as jtrain_engine
from multimodal_transformer_tpu.models import build_model as jbuild_model
from multimodal_transformer_tpu.models import default_config as jdefault_config
from multimodal_transformer_tpu.ops import basic as jbasic
from multimodal_transformer_tpu_torch import default_config
from multimodal_transformer_tpu_torch.engine import (Engine, NanGuard,
                                                     NonFiniteError,
                                                     load_model,
                                                     save_checkpoint)
from multimodal_transformer_tpu_torch.engine import flax_msgpack
from multimodal_transformer_tpu_torch.engine.convert import port_tree
from multimodal_transformer_tpu_torch.utils.params import (export_params,
                                                           flatten_tree,
                                                           unflatten_tree)

AVL = ("acoustic", "image", "linguistic")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: under the suite's parallel workers, torch's
    thread pool on every small op of these CPU training runs oversubscribes
    the cores (an epoch measured 100x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _hash_dropout():
    jbasic.set_dropout_impl("hash")
    yield
    jbasic.set_dropout_impl(None)


def _cfg(family, mods, variant="default", acoustic_embed=88,
         mask_mode="query"):
    cfg = default_config(family, mods, acoustic_embed=acoustic_embed,
                         mask_mode=mask_mode, variant=variant)
    object.__setattr__(cfg, "mod_dimension", dict(SMALL_DIMS))
    return cfg


def _random_state(cfg, seed=0):
    rs = np.random.RandomState(seed)
    return {k: rs.randn(*v.shape).astype(np.float32)
            for k, v in flatten_tree(port_tree(cfg)).items()}


@pytest.mark.parametrize("family,mods,variant,a_dim", [
    ("MFT", AVL, "default", 44), ("MFT", ("linguistic",), "default", 88),
    ("SFT", AVL, "default", 88), ("SFT", ("acoustic",), "default", 88),
    ("B1-LSTM", ("image", "linguistic"), "default", 88),
    ("B1-LSTM", ("linguistic",), "legacy", 88),
    ("B2-Trans", ("image", "linguistic"), "default", 88),
    ("B3-MFN", AVL, "default", 88)])
def test_pth_round_trip_and_jax_layout(tmp_path, family, mods, variant,
                                       a_dim):
    cfg = _cfg(family, mods, variant, a_dim)
    state = _random_state(cfg)
    path = str(tmp_path / "m.pth")
    save_checkpoint(cfg, state, path)
    got_cfg, got = load_model(path, family)
    assert got_cfg == cfg
    assert got.keys() == state.keys()
    assert all(np.array_equal(got[k], state[k]) for k in state)

    ck = torch.load(path, weights_only=True)
    assert (ck["modalities"], ck["mod_dimension"], ck["window_size"]) == (
        list(mods), cfg.mod_dimension, cfg.window_size)
    jcfg = jdefault_config(family, mods, acoustic_embed=a_dim,
                           variant=variant)
    object.__setattr__(jcfg, "mod_dimension", dict(SMALL_DIMS))
    want = jconvert.export_state_dict(jcfg, unflatten_tree(state))
    assert ck["model"].keys() == want.keys()
    assert all(np.array_equal(ck["model"][k].numpy(), want[k]) for k in want)
    if variant != "legacy" and (family, len(mods)) != ("SFT", 1):
        return  # the JAX convert_pth's eager init costs 1-8 s a family
    jcfg2, jparams, _ = jconvert.convert_pth(path, family)
    assert jcfg2.variant == variant
    assert jcfg2.window_embed_size == cfg.window_embed_size
    jflat = flatten_tree(jax.tree_util.tree_map(np.asarray, jparams))
    assert jflat.keys() == state.keys()
    assert all(np.array_equal(jflat[k], state[k]) for k in state)


def _same_tree(got, want, path="root"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            _same_tree(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same_tree(g, w, f"{path}.{i}")
    elif isinstance(want, (np.ndarray, np.generic)):
        g = np.asarray(got)
        assert g.dtype == want.dtype and g.shape == want.shape, path
        assert np.array_equal(g, want, equal_nan=True), path
    else:
        assert type(got) is type(want) and got == want, path


def test_msgpack_decoder_equals_flax(tmp_path, monkeypatch):
    cfg = _cfg("B3-MFN", ("acoustic", "linguistic"))
    tree = jax.tree_util.tree_map(jnp.asarray,
                                  unflatten_tree(_random_state(cfg)))
    ckpt = str(tmp_path / "m.ckpt")
    jcheckpoint.save_checkpoint(cfg.modalities, cfg.mod_dimension,
                                cfg.window_size, tree, ckpt)
    opt = {"step": np.asarray(7, np.int32),
           "m": jax.tree_util.tree_map(lambda p: np.asarray(p) * 0.5, tree),
           "v": jax.tree_util.tree_map(lambda p: np.asarray(p) ** 2, tree)}
    for name, o in (("tree", opt), ("flat", joptim.opt_state_to_flat(opt))):
        jcheckpoint.save_train_state(
            str(tmp_path / f"{name}.state"), params=tree, opt_state=o,
            epoch=3, scheduler_state={"lr": 1e-4, "best": float("inf"),
                                      "num_bad": 2},
            best_ccc=0.25, modalities=cfg.modalities,
            mod_dimension=cfg.mod_dimension, window_size=cfg.window_size)
    for f in ("m.ckpt", "tree.state", "flat.state"):
        buf = (tmp_path / f).read_bytes()
        _same_tree(flax_msgpack.loads(buf), serialization.msgpack_restore(buf))

    rs = np.random.RandomState(0)
    everything = {
        "ints": [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
                 2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
                 -2 ** 31, -2 ** 31 - 1, -2 ** 63],
        "floats": [1.5, -0.0, float("inf"), 1e-300], "none": None,
        "bools": [True, False], "str": "x" * 40, "str16": "y" * 300,
        "bin": b"\x00\x01" * 200, "list16": list(range(20)),
        "map16": {str(i): i for i in range(20)}, "complex": 1 + 2j,
        "scalar": np.float32(2.5), "i8": np.arange(6, dtype=np.int8),
        "f64": rs.randn(2, 3), "bool": np.array([True, False]),
        "empty": np.zeros((0, 4), np.float32)}
    buf = serialization.msgpack_serialize(everything)
    _same_tree(flax_msgpack.loads(buf), serialization.msgpack_restore(buf))
    bf16 = serialization.msgpack_serialize(
        {"w": jnp.asarray(rs.randn(3, 5), jnp.bfloat16)})
    np.testing.assert_array_equal(
        flax_msgpack.loads(bf16)["w"],
        np.asarray(serialization.msgpack_restore(bf16)["w"], np.float32))

    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    chunked = serialization.msgpack_serialize({"w": rs.randn(40)})
    with pytest.raises(ValueError, match="chunked"):
        flax_msgpack.loads(chunked)
    with pytest.raises(ValueError, match="ends early"):
        flax_msgpack.loads(buf[:-3])


def _epoch_data(V=6, W=8, seed=5):
    rs = np.random.RandomState(seed)
    data = {m: rs.randn(V, W, 3, SMALL_DIMS[m]).astype(np.float32)
            for m in AVL}
    target = rs.randn(V, W).astype(np.float32)
    lens = [int(n) for n in rs.randint(2, W + 1, size=V)]
    lens[0] = W
    return data, target, lens


def _engine(**kw):
    return Engine(_cfg("MFT", AVL, mask_mode="key_query"), seed=2,
                  device="cpu", **kw)


def _same_params(a: Engine, b: Engine) -> bool:
    sa, sb = a.module.state_dict(), b.module.state_dict()
    return all(torch.equal(sa[k], sb[k]) for k in sa)


def test_resume_and_prefetch_are_bit_identical(tmp_path):
    data, target, lens = _epoch_data()
    whole = _engine()
    rng = np.random.RandomState(0)
    losses = [whole.train_epoch(data, target, lens, batch_size=3, rng=rng)
              for _ in range(2)]
    whole.scheduler_step(1.0)

    first = _engine()
    rng = np.random.RandomState(0)
    assert first.train_epoch(data, target, lens, batch_size=3, rng=rng,
                             prefetch=0) == losses[0]
    first.scheduler_step(1.0)
    path = str(tmp_path / "t.state")
    first.save_state(path, best_ccc=0.5)
    resumed = _engine()
    assert resumed.restore_state(path) == 0.5
    assert (resumed._epoch, resumed.steps, resumed.scheduler.best) == (
        1, 2, 1.0)
    assert resumed.train_epoch(data, target, lens, batch_size=3,
                               rng=rng) == losses[1]
    assert _same_params(whole, resumed)
    sa, sb = whole.optimizer.state_dict(), resumed.optimizer.state_dict()
    for i, st in sa["state"].items():
        for k, v in st.items():
            assert torch.equal(v, sb["state"][i][k])


@pytest.mark.parametrize("V", [6, 7])
def test_resident_epoch_equals_host_epoch(V):
    """Six videos: the host's batches at full length, bit for bit.  Seven:
    the last resident batch holds one video and two filler rows, whose
    target and mask are zero; dropout off (the MFN head's dropout indexes
    [T, B, H], so the batch's rows move its positions), its loss is the host
    batch's up to the order of float32 sums."""
    data, target, lens = _epoch_data(V=V)
    seed_fn = None if V == 6 else (lambda step, T: None)
    host, resident = _engine(seed_fn=seed_fn), _engine(seed_fn=seed_fn)
    losses = []
    for eng in (host, resident):
        spy = []
        step = eng.train_step
        eng.train_step = lambda batch, _s=step, _l=spy: _l.append(
            _s(batch)) or _l[-1]
        losses.append(spy)
    host.train_epoch(data, target, lens, batch_size=3,
                     rng=np.random.RandomState(1), pad_time_to=8)
    store = resident.upload_dataset(data, target, lens)
    resident.train_epoch_resident(store, batch_size=3,
                                  rng=np.random.RandomState(1))
    if V == 6:
        assert losses[0] == losses[1]
        assert _same_params(host, resident)
    else:
        np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)


def test_jax_state_continues_the_jax_trajectory(tmp_path, monkeypatch):
    mods = ("image", "linguistic")
    cfg = _cfg("B2-Trans", mods, mask_mode="key_query")
    data, target, lens = _epoch_data()
    data = {m: data[m] for m in mods}
    eng = Engine(cfg, seed=2, device="cpu")
    tree = export_params(eng.module)
    jcfg = jdefault_config("B2-Trans", mods, mask_mode="key_query")
    object.__setattr__(jcfg, "mod_dimension", dict(SMALL_DIMS))
    _, apply = jbuild_model(jcfg)
    monkeypatch.setattr(jtrain_engine, "build_model", lambda c: (
        lambda key: jax.tree_util.tree_map(jnp.asarray, tree), apply))
    jeng = jtrain_engine.Engine(jcfg, seed=1)
    rng = np.random.RandomState(0)
    jeng.train_epoch(data, target, lens, batch_size=3, rng=rng)
    jeng.scheduler_step(0.5)
    paths = {"tree": str(tmp_path / "tree.state"),
             "flat": str(tmp_path / "flat.state")}
    jeng.save_state(paths["tree"], best_ccc=0.125)
    flat = joptim.opt_state_to_flat(jeng.opt_state)
    jcheckpoint.save_train_state(
        paths["flat"], params=jeng.params, opt_state=flat, epoch=1,
        scheduler_state={"lr": jeng.scheduler.lr, "best": 0.5, "num_bad": 0},
        best_ccc=0.125, modalities=mods, mod_dimension=jcfg.mod_dimension,
        window_size=jcfg.window_size)
    after_one = rng.get_state()
    want_loss = jeng.train_epoch(data, target, lens, batch_size=3, rng=rng)
    want = {k: np.asarray(v) for k, v in flatten_tree(jeng.params).items()}

    def seed_fn(step, T):  # two steps an epoch, keys from the epoch
        key = jax.random.fold_in(jax.random.PRNGKey(step // 2 + 1), step % 2)
        return jax_family_seeds(key, cfg, T)

    for layout, path in paths.items():
        port = Engine(cfg, seed=3, device="cpu", seed_fn=seed_fn)
        assert port.restore_state(path) == 0.125
        assert (port._epoch, port.steps, port.scheduler.best) == (1, 2, 0.5)
        rng = np.random.RandomState()
        rng.set_state(after_one)
        loss = port.train_epoch(data, target, lens, batch_size=3, rng=rng)
        assert loss == pytest.approx(want_loss, rel=1e-5), layout
        got = {k: v.numpy() for k, v in port.module.state_dict().items()}
        diff = np.sqrt(sum(np.sum((got[k] - want[k]) ** 2) for k in want))
        norm = np.sqrt(sum(np.sum(w ** 2) for w in want.values()))
        assert diff <= 1e-5 * norm, layout


def test_nan_guard_names_the_bad_parameters():
    named = {"a.w": torch.ones(3), "b.w": torch.tensor([1.0, float("nan")]),
             "c.b": torch.tensor([float("inf")])}
    guard = NanGuard(check_every=2)
    guard.check(1.0, named)  # step 1: loss only
    with pytest.raises(NonFiniteError, match=r"\['b.w', 'c.b'\]"):
        guard.check(1.0, named)
    with pytest.raises(NonFiniteError, match="loss became non-finite"):
        NanGuard().check(float("nan"))
    eng = Engine(_cfg("B2-Trans", ("linguistic",)), device="cpu",
                 logger=logging.getLogger("test_torch_checkpoint"))
    data, target, lens = _epoch_data()
    target[:] = np.inf
    with pytest.raises(NonFiniteError, match="step 1"):
        eng.train_epoch({"linguistic": data["linguistic"]}, target, lens,
                        batch_size=3)
    eng = Engine(_cfg("B2-Trans", ("linguistic",)), device="cpu")
    eng.nan_guard.check_every = 1
    with torch.no_grad():
        eng.module.get_parameter(
            "Transformer.out_fc2.bias").fill_(float("nan"))
    with pytest.raises(NonFiniteError, match="Transformer.out_fc2.bias"):
        eng.nan_guard.check(1.0, eng.module.named_parameters())
