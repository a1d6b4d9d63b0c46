"""Port parity for the training slice, float32 on the CPU:

  * the MFT A+V+L training loss and every parameter gradient at full widths
    (B=2, T=8, lengths [8, 5], key_query) against `mft_apply(rng=key)` under
    `jax.value_and_grad`, with the dropout seeds derived from the same key:
    loss rtol 1e-5; each gradient within 2e-3 of its own L2 norm plus 1e-6
    of the whole gradient's (float32 sums in another order; the k-projection
    bias gradients are mathematically zero, so theirs is rounding noise);
  * a three-step `Engine.train_epoch` against the JAX `Engine` (small
    modality widths, full encoder and MFN widths), both from the same
    weights: the logged lines are identical, and the parameter updates of
    the three Adam steps agree within 1e-2 relative L2 over all parameters
    and lr = 1e-4 per element (Adam divides each gradient element by its
    own running scale, so a rounding-level gradient difference can move a
    parameter by up to lr per step);
  * `make_batches`, Adam and `ReduceLROnPlateau` against the JAX package.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from make_goldens import SMALL_DIMS

from multimodal_transformer_tpu.data.batching import \
    make_batches as jmake_batches
from multimodal_transformer_tpu.engine import optim as joptim
from multimodal_transformer_tpu.engine import train_engine as jtrain_engine
from multimodal_transformer_tpu.models import build_model as jbuild_model
from multimodal_transformer_tpu.models import default_config as jdefault_config
from multimodal_transformer_tpu.ops import basic as jbasic
from multimodal_transformer_tpu_torch import build_model, default_config
from multimodal_transformer_tpu_torch.data import make_batches
from multimodal_transformer_tpu_torch.engine import (Engine, ReduceLROnPlateau,
                                                     make_adam)
from multimodal_transformer_tpu_torch.ops.seeds import DropoutSeeds
from multimodal_transformer_tpu_torch.utils.params import (export_params,
                                                           flatten_tree)
from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401


AVL = ("acoustic", "image", "linguistic")
GRAD_RTOL, GRAD_FLOOR = 2e-3, 1e-6


@pytest.fixture(autouse=True)
def _hash_dropout_no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    jbasic.set_dropout_impl("hash")
    yield
    jbasic.set_dropout_impl(None)


def jax_family_seeds(key, cfg, T: int) -> DropoutSeeds:
    """The per-site seeds that the family's JAX apply draws from the JAX key
    `key`, as the port's DropoutSeeds: `DropoutSeeds.from_key` over the
    configuration's sites (held to the JAX key tree by
    tests/test_torch_prng.py)."""
    sites = build_model(cfg, device="meta").dropout_sites()
    return DropoutSeeds.from_key(sites, np.asarray(jax.random.key_data(key)),
                                 T)


def _grad_errors(got: dict, want: dict):
    total = np.sqrt(sum(float(np.sum(np.square(v, dtype=np.float64)))
                        for v in want.values()))
    worst = 0.0
    for k, w in want.items():
        diff = np.linalg.norm((got[k] - w).ravel())
        limit = GRAD_RTOL * np.linalg.norm(w.ravel()) + GRAD_FLOOR * total
        worst = max(worst, diff / limit)
    return worst


def _port_and_tree(cfg, seed: int):
    """A port module with the JAX init's weights for seed, and the same
    weights as the JAX package's parameter tree (cheaper than the JAX
    package's eager init)."""
    module = build_model(cfg, seed=seed)
    return module, export_params(module)


def test_mft_train_loss_and_grads_match_jax():
    cfg = default_config("MFT", AVL, mask_mode="key_query")
    jcfg = jdefault_config("MFT", AVL, mask_mode="key_query")
    _, apply = jbuild_model(jcfg)
    module, params = _port_and_tree(cfg, 3)
    B, T = 2, 8
    rs = np.random.RandomState(4)
    frames = {"acoustic": 3, "image": 2, "linguistic": 4}
    data = {m: rs.randn(B, T, frames[m], cfg.mod_dimension[m]).astype(
        np.float32) for m in AVL}
    target = rs.randn(B, T, 1).astype(np.float32)
    mask = np.ones((B, T, 1), np.float32)
    mask[1, 5:] = 0.0
    denom = float(mask.sum())
    key = jax.random.PRNGKey(21)

    def loss_fn(p):
        pred = apply(p, {m: jnp.asarray(v) for m, v in data.items()},
                     jnp.asarray(mask), rng=key)
        return jnp.sum((pred - target) ** 2) / denom

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(params)

    pred = module({m: torch.from_numpy(v) for m, v in data.items()},
                  torch.from_numpy(mask), seeds=jax_family_seeds(key, cfg, T))
    loss = ((pred - torch.from_numpy(target)) ** 2).sum() / denom
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-5)
    got = {k: v.grad.numpy() for k, v in module.named_parameters()}
    want = {k: np.asarray(v) for k, v in flatten_tree(want_grads).items()}
    assert set(got) == set(want)
    assert _grad_errors(got, want) <= 1.0


def test_engine_three_steps_match_jax_engine(monkeypatch):
    jcfg = jdefault_config("MFT", AVL, mask_mode="key_query")
    object.__setattr__(jcfg, "mod_dimension", dict(SMALL_DIMS))
    cfg = default_config("MFT", AVL, mask_mode="key_query")
    object.__setattr__(cfg, "mod_dimension", dict(SMALL_DIMS))
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
        log = logging.getLogger(f"test_torch_train.{side}")
        log.setLevel(logging.INFO)
        log.propagate = False
        logs[side] = Lines()
        log.addHandler(logs[side])

    def seed_fn(step, T):
        return jax_family_seeds(jax.random.fold_in(jax.random.PRNGKey(1),
                                                   step), cfg, T)

    eng = Engine(cfg, seed=2, seed_fn=seed_fn, device="cpu",
                 logger=logging.getLogger("test_torch_train.port"))
    tree = export_params(eng.module)
    _, apply = jbuild_model(jcfg)
    monkeypatch.setattr(jtrain_engine, "build_model", lambda c: (
        lambda key: jax.tree_util.tree_map(jnp.asarray, tree), apply))
    jeng = jtrain_engine.Engine(jcfg, seed=1,
                                logger=logging.getLogger("test_torch_train.jax"))
    jeng.train_epoch(data, target, lens, batch_size=3,
                     rng=np.random.RandomState(0), pad_time_to=8)
    eng.train_epoch(data, target, lens, batch_size=3,
                    rng=np.random.RandomState(0), pad_time_to=8)

    assert len(logs["port"].lines) == 5 and logs["port"].lines[3] == "---"
    assert logs["port"].lines == logs["jax"].lines
    start = flatten_tree(tree)
    want = {k: np.asarray(v) - start[k]
            for k, v in flatten_tree(jeng.params).items()}
    got = {k: v.numpy() - start[k] for k, v in eng.module.state_dict().items()}
    diff = np.sqrt(sum(np.sum((got[k] - want[k]) ** 2) for k in want))
    norm = np.sqrt(sum(np.sum(w ** 2) for w in want.values()))
    assert diff <= 1e-2 * norm
    assert max(np.abs(got[k] - want[k]).max() for k in want) <= 1e-4


@pytest.mark.parametrize("shuffle,pad", [(False, None), (True, None),
                                         (True, 4)])
def test_make_batches_match_jax(shuffle, pad):
    rs = np.random.RandomState(0)
    lens = [3, 8, 5, 11, 14, 7, 1, 12]
    data = {"a": rs.randn(8, 14, 2, 3).astype(np.float32)}
    target = rs.randn(8, 14).astype(np.float32)
    got = list(make_batches(data, target, lens, 3, shuffle,
                            np.random.RandomState(7), pad))
    want = list(jmake_batches(data, target, lens, 3, shuffle,
                              np.random.RandomState(7), pad))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.lengths == w.lengths and g.indices == w.indices
        np.testing.assert_array_equal(g.mask, w.mask)
        np.testing.assert_array_equal(g.target, w.target)
        np.testing.assert_array_equal(g.data["a"], w.data["a"])


def test_adam_matches_jax_adam():
    rs = np.random.RandomState(1)
    p0 = rs.randn(6, 5).astype(np.float32)
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = make_adam([tp], lr=1e-2)
    cur = {"w": jnp.asarray(p0)}
    state = joptim.adam_init(cur)
    for _ in range(6):
        g = rs.randn(6, 5).astype(np.float32)
        cur, state = joptim.adam_update(cur, {"w": jnp.asarray(g)}, state,
                                        jnp.asarray(1e-2), weight_decay=1e-4)
        tp.grad = torch.from_numpy(g)
        opt.step()
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(cur["w"]),
                               rtol=1e-5, atol=1e-6)


def test_reduce_lr_on_plateau_matches_jax():
    metrics = [5.0, 4.0, 4.0, 3.9999, 4.1, 4.2, 4.3, 3.0, 3.5, 3.5, 3.5]
    a = ReduceLROnPlateau(lr=1e-3, patience=2)
    b = joptim.ReduceLROnPlateau(lr=1e-3, patience=2)
    assert [a.step(m) for m in metrics] == [b.step(m) for m in metrics]
    assert a.lr < 1e-3
