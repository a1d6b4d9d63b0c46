"""Port parity for the training of every family, float32 on the CPU:

  * each configuration's training loss and every parameter gradient against
    `jax.value_and_grad` of the family's JAX apply with `rng=key`, from the
    same parameters (carried over with `load_jax_params`) and the dropout
    seeds that the apply's key tree gives (`jax_family_seeds`), with the
    "hash" dropout pinned: B=2, T=8, lengths [8, 5], the golden modality
    widths (make_goldens.SMALL_DIMS), every other width at its default.
    Loss within 1e-5 relative; each gradient within 1e-4 of its own L2 norm
    plus 1e-6 of the whole gradient's (float32 sums in another order; the
    k-projection bias gradients are mathematically zero, so theirs is
    rounding noise);
  * two epochs of the port's `Engine` reproduce the JAX package's train
    goldens (tests/goldens/train_<name>_jnp.npz, built by
    make_goldens.build_train_case): the epoch losses within 1e-5 relative
    plus 1e-6 absolute, and every parameter leaf's sum and absolute sum
    within 5e-5 relative (2.1e-5 seen, on B1's 1,024-wide leaves of sums
    up to ~300) plus twice the JAX package's own spread (the
    largest difference between its jnp and its kernel golden of the same
    run, up to 2.5e-4 on sums of magnitude ~10) plus 2e-5: Adam divides
    each gradient element by its own running scale, so a rounding-level
    gradient difference (the zero-gradient biases above) moves a parameter
    by up to lr = 1e-3 per step;
  * the encoders' "stack" backward route against "perlayer" through `Engine`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from make_goldens import GOLDEN_DIR, SMALL_DIMS, TRAIN_CASES
from test_torch_train import jax_family_seeds

from multimodal_transformer_tpu.models import build_model as jbuild_model
from multimodal_transformer_tpu.models import default_config as jdefault_config
from multimodal_transformer_tpu.ops import basic as jbasic
from multimodal_transformer_tpu_torch import build_model, default_config
from multimodal_transformer_tpu_torch.data import Batch
from multimodal_transformer_tpu_torch.engine import Engine
from multimodal_transformer_tpu_torch.utils.params import (export_params,
                                                           flatten_tree,
                                                           load_jax_params)
from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401


AVL = ("acoustic", "image", "linguistic")
# the training configurations: (family, modalities, variant)
CONFIGS = {
    "sft_avl": ("SFT", AVL, "default"),
    "sft_a": ("SFT", ("acoustic",), "default"),
    "b2_avl": ("B2-Trans", AVL, "default"),
    "b3_avl": ("B3-MFN", AVL, "default"),
    "b3_v": ("B3-MFN", ("image",), "default"),
    "b1_avl": ("B1-LSTM", AVL, "default"),
    "b1_legacy_l": ("B1-LSTM", ("linguistic",), "legacy"),
    "mft_l": ("MFT", ("linguistic",), "default"),
}
LOSS_RTOL, GRAD_RTOL, GRAD_FLOOR = 1e-5, 1e-4, 1e-6
GOLDEN_RTOL, GOLDEN_ATOL, SUM_RTOL, SUM_FLOOR = 1e-5, 1e-6, 5e-5, 2e-5


@pytest.fixture(autouse=True)
def _hash_dropout_no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    jbasic.set_dropout_impl("hash")
    yield
    jbasic.set_dropout_impl(None)


def _configs(family, mods, variant, mask_mode):
    out = []
    for fn in (jdefault_config, default_config):
        cfg = fn(family, mods, mask_mode=mask_mode, variant=variant)
        object.__setattr__(cfg, "mod_dimension", dict(SMALL_DIMS))
        out.append(cfg)
    return out


def _grad_errors(got: dict, want: dict) -> float:
    total = np.sqrt(sum(float(np.sum(np.square(v, dtype=np.float64)))
                        for v in want.values()))
    worst = 0.0
    for k, w in want.items():
        diff = np.linalg.norm((got[k] - w).ravel())
        limit = GRAD_RTOL * np.linalg.norm(w.ravel()) + GRAD_FLOOR * total
        worst = max(worst, diff / limit)
    return worst


def _case(mods, B=2, T=8, Fr=3, seed=4):
    rs = np.random.RandomState(seed)
    data = {m: rs.randn(B, T, Fr, SMALL_DIMS[m]).astype(np.float32)
            for m in mods}
    target = rs.randn(B, T, 1).astype(np.float32)
    mask = np.ones((B, T, 1), np.float32)
    mask[1, 5:] = 0.0
    return data, target, mask


@pytest.mark.parametrize("mask_mode", ["key_query", "query"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_family_train_loss_and_grads_match_jax(name, mask_mode):
    family, mods, variant = CONFIGS[name]
    jcfg, cfg = _configs(family, mods, variant, mask_mode)
    _, apply = jbuild_model(jcfg)
    module = build_model(cfg, seed=3)
    params = export_params(module)
    data, target, mask = _case(mods)
    T = mask.shape[1]
    denom = float(mask.sum())
    key = jax.random.PRNGKey(21)

    def loss_fn(p):
        pred = apply(p, {m: jnp.asarray(v) for m, v in data.items()},
                     jnp.asarray(mask), rng=key)
        return jnp.sum((pred - target) ** 2) / denom

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(params)

    pred = module({m: torch.from_numpy(v) for m, v in data.items()},
                  torch.from_numpy(mask),
                  seeds=jax_family_seeds(key, cfg, T))
    loss = ((pred - torch.from_numpy(target)) ** 2).sum() / denom
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want_loss),
                                                 rel=LOSS_RTOL)
    got = {k: v.grad.numpy() for k, v in module.named_parameters()
           if v.grad is not None}
    want = {k: np.asarray(v) for k, v in flatten_tree(want_grads).items()}
    # the single-modality SFT's fusion layer is created but never used: no
    # gradient reaches it on either side
    unused = {k for k, v in want.items() if k not in got}
    assert all(not want[k].any() for k in unused)
    assert unused <= {"fusionLayer.weight", "fusionLayer.bias"}
    assert _grad_errors(got, {k: v for k, v in want.items()
                              if k not in unused}) <= 1.0


def _golden_seed_fn(cfg, batches_per_epoch: int):
    """The JAX Engine's step keys, fold_in(PRNGKey(epoch), batch), with
    epochs counted from 1 (train_engine.py there), through the family's
    key tree."""
    def seed_fn(step, T):
        epoch, batch = divmod(step, batches_per_epoch)
        key = jax.random.fold_in(jax.random.PRNGKey(epoch + 1), batch)
        return jax_family_seeds(key, cfg, T)
    return seed_fn


@pytest.mark.parametrize("name,family,mods", TRAIN_CASES,
                         ids=[c[0] for c in TRAIN_CASES])
def test_engine_reproduces_train_golden(name, family, mods):
    """make_goldens.build_train_case with kernel=False, on the port's
    Engine: SMALL_DIMS, lr 1e-3, the JAX Engine(seed=7)'s initial
    parameters, batches from RandomState(3) each epoch."""
    jcfg, cfg = _configs(family, mods, "default", "key_query")
    init, _ = jbuild_model(jcfg)
    tree = jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(7)))
    rs = np.random.RandomState(5)
    B, W, Fr = 4, 7, 4
    data = {m: rs.randn(B, W, Fr, SMALL_DIMS[m]).astype(np.float32)
            for m in mods}
    target = (rs.randn(B, W) * 0.3).astype(np.float32)
    seq_lens = [7, 6, 5, 7]
    eng = Engine(cfg, lr=1e-3, device="cpu",
                 seed_fn=_golden_seed_fn(cfg, batches_per_epoch=2))
    load_jax_params(eng.module, tree)
    losses = [eng.train_epoch(data, target, seq_lens, batch_size=2,
                              rng=np.random.RandomState(3))
              for _ in range(2)]
    leaves = [np.asarray(l, np.float64) for l in
              jax.tree_util.tree_leaves(export_params(eng.module))]
    want = np.load(f"{GOLDEN_DIR}/train_{name}_jnp.npz")
    other = np.load(f"{GOLDEN_DIR}/train_{name}_kernel.npz")
    spread = max(np.abs(want[k] - other[k]).max() for k in ("sums",
                                                            "abs_sums"))
    np.testing.assert_allclose(losses, want["losses"], rtol=GOLDEN_RTOL,
                               atol=GOLDEN_ATOL)
    np.testing.assert_allclose([l.sum() for l in leaves], want["sums"],
                               rtol=SUM_RTOL, atol=2 * spread + SUM_FLOOR)
    np.testing.assert_allclose([np.abs(l).sum() for l in leaves],
                               want["abs_sums"], rtol=SUM_RTOL,
                               atol=2 * spread + SUM_FLOOR)


@pytest.mark.parametrize("name", ["sft_avl", "b2_avl"])
def test_engine_stack_backward_gives_the_perlayer_step(name):
    """On the CPU both routes take the plain encoder: the same step, bit for
    bit, from the same parameters, batch and seeds."""
    family, mods, variant = CONFIGS[name]
    _, cfg = _configs(family, mods, variant, "key_query")
    data, target, mask = _case(mods)
    batch = Batch(data, target, mask, [8, 5])
    states = []
    for backward in ("perlayer", "stack"):
        eng = Engine(cfg, seed=3, device="cpu", encoder_backward=backward)
        eng.train_step(batch)
        states.append(eng.module.state_dict())
    assert all(torch.equal(states[0][k], states[1][k]) for k in states[0])


def test_engine_refuses_an_unknown_encoder_backward():
    _, cfg = _configs("B2-Trans", AVL, "default", "key_query")
    with pytest.raises(ValueError, match="encoder_backward"):
        Engine(cfg, device="cpu", encoder_backward="chunked")
