"""Port parity for the five families, float32 on the CPU at the golden
widths (make_goldens.SMALL_DIMS, B=2, W=7), atol 1e-4 on valid (mask == 1)
positions, as test_torch_slice.py holds the MFT A+V+L:

  * every family / variant / modality set against the JAX `build_model`
    apply, in both mask modes, from the same parameters (carried over with
    `load_jax_params`);
  * the committed goldens of make_goldens.CASES;
  * `export_params` -> JAX tree -> `load_jax_params` round trips, key for key;
  * the port's `ValencePredictor` against the JAX one on a request of mixed
    lengths over two buckets;
  * every configuration's training forward (seeds from the JAX apply's key
    tree) against the JAX apply with that key; tests/test_torch_train_
    families.py holds the training gradients.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from make_goldens import CASES, GOLDEN_DIR, SMALL_DIMS
from test_torch_train import jax_family_seeds

from multimodal_transformer_tpu.models import build_model as jbuild_model
from multimodal_transformer_tpu.models import default_config as jdefault_config
from multimodal_transformer_tpu.ops import basic as jbasic
from multimodal_transformer_tpu.serve import ValencePredictor as JPredictor
from multimodal_transformer_tpu_torch import (ValencePredictor, build_model,
                                              default_config)
from multimodal_transformer_tpu_torch.utils.params import (export_params,
                                                           flatten_tree,
                                                           load_jax_params)
from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401


ATOL = 1e-4
AVL = ("acoustic", "image", "linguistic")
# (family, modalities, variant)
CONFIGS = {
    "mft_l": ("MFT", ("linguistic",), "default"),
    "sft_vl": ("SFT", ("image", "linguistic"), "default"),
    "sft_avl": ("SFT", AVL, "default"),
    "sft_a": ("SFT", ("acoustic",), "default"),
    "b1_l": ("B1-LSTM", ("linguistic",), "default"),
    "b1_avl": ("B1-LSTM", AVL, "default"),
    "b1_legacy": ("B1-LSTM", ("linguistic",), "legacy"),
    "b2_vl": ("B2-Trans", ("image", "linguistic"), "default"),
    "b2_a": ("B2-Trans", ("acoustic",), "default"),
    "b3_al": ("B3-MFN", ("acoustic", "linguistic"), "default"),
    "b3_avl": ("B3-MFN", AVL, "default"),
    "b3_v": ("B3-MFN", ("image",), "default"),
}
GOLDEN_CASES = ["mft_single", "sft_vl", "b1_l", "b1_legacy", "b2_vl",
                "b2_vl_keymask", "b3_al"]


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _configs(family, mods, variant, mask_mode="query"):
    out = []
    for fn in (jdefault_config, default_config):
        cfg = fn(family, mods, mask_mode=mask_mode, variant=variant)
        object.__setattr__(cfg, "mod_dimension", dict(SMALL_DIMS))
        out.append(cfg)
    return out


@contextlib.contextmanager
def jbasic_hash_dropout():
    """The JAX package's "hash" dropout, the stream the port reproduces."""
    jbasic.set_dropout_impl("hash")
    try:
        yield
    finally:
        jbasic.set_dropout_impl(None)


def _jax_params(jcfg, seed):
    init, _ = jbuild_model(jcfg)
    return jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(seed)))


def _port(cfg, params):
    return load_jax_params(build_model(cfg), params).eval()


def _inputs(mods, seed, B=2, W=7, Fr=4):
    rs = np.random.RandomState(seed)
    inputs = {m: rs.randn(B, W, Fr, SMALL_DIMS[m]).astype(np.float32)
              for m in mods}
    mask = np.ones((B, W, 1), np.float32)
    mask[1, 5:] = 0.0
    return inputs, mask


def _run_port(module, inputs, mask):
    with torch.no_grad():
        return module({m: torch.from_numpy(v) for m, v in inputs.items()},
                      torch.from_numpy(mask)).numpy()


@pytest.mark.parametrize("mask_mode", ["query", "key_query"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_family_forward_matches_jax(name, mask_mode):
    family, mods, variant = CONFIGS[name]
    jcfg, cfg = _configs(family, mods, variant, mask_mode)
    params = _jax_params(jcfg, 7)
    inputs, mask = _inputs(mods, 11)
    _, apply = jbuild_model(jcfg)
    want = np.asarray(apply(params, {m: jnp.asarray(v)
                                     for m, v in inputs.items()},
                            jnp.asarray(mask)))
    got = _run_port(_port(cfg, params), inputs, mask)
    valid = mask[..., 0] > 0
    assert got.shape == want.shape == mask.shape
    np.testing.assert_allclose(got[valid], want[valid], atol=ATOL)
    assert (got[~valid] == 0).all()


@pytest.mark.parametrize("case", GOLDEN_CASES)
def test_family_matches_golden(case):
    """tests/goldens/<case>.npz, with the parameters and inputs of
    make_goldens.build_case."""
    _, family, mods, mask_mode, variant = next(c for c in CASES
                                               if c[0] == case)
    jcfg, cfg = _configs(family, mods, variant, mask_mode)
    params = _jax_params(jcfg, 1234)
    inputs, mask = _inputs(mods, 99)
    want = np.load(f"{GOLDEN_DIR}/{case}.npz")["out"]
    got = _run_port(_port(cfg, params), inputs, mask)
    valid = mask[..., 0] > 0
    np.testing.assert_allclose(got[valid], want[valid], atol=ATOL)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_export_params_round_trips(name):
    family, mods, variant = CONFIGS[name]
    jcfg, cfg = _configs(family, mods, variant)
    params = _jax_params(jcfg, 2)
    module = _port(cfg, params)
    tree = export_params(module)
    assert jax.tree_util.tree_structure(tree) == \
        jax.tree_util.tree_structure(params)
    a, b = flatten_tree(tree), flatten_tree(params)
    assert all(np.array_equal(a[k], b[k]) for k in b)
    again = load_jax_params(build_model(cfg), tree)
    assert all(torch.equal(x, y) for x, y in zip(
        again.state_dict().values(), module.state_dict().values()))


@pytest.mark.parametrize("name", ["sft_vl", "b1_l", "b2_vl", "b3_al"])
def test_predictor_matches_jax_predictor(name):
    """6 videos of mixed lengths over 2 buckets (time_multiple=8,
    batch_size=4)."""
    family, mods, variant = CONFIGS[name]
    jcfg, cfg = _configs(family, mods, variant, "key_query")
    params = _jax_params(jcfg, 5)
    lens = [3, 8, 5, 11, 14, 7]
    rs = np.random.RandomState(3)
    data = {m: rs.randn(6, 14, 4, SMALL_DIMS[m]).astype(np.float32)
            for m in mods}
    want = JPredictor(jcfg, params, batch_size=4, time_multiple=8,
                      bf16=False).predict_padded(data, lens)
    pred = ValencePredictor(cfg, _port(cfg, params), device="cpu",
                            batch_size=4, time_multiple=8, bf16=False)
    got = pred.predict_padded(data, lens)
    assert [len(g) for g in got] == lens
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, w, atol=ATOL)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_training_forward_raises_until_ported(name):
    """Training is ported for every family: the forward with dropout seeds
    (those of `apply(rng=key)`, built by the family's key tree) runs, no
    longer raises, and equals the JAX apply with that key."""
    family, mods, variant = CONFIGS[name]
    jcfg, cfg = _configs(family, mods, variant, "key_query")
    params = _jax_params(jcfg, 7)
    inputs, mask = _inputs(mods, 1)
    key = jax.random.PRNGKey(13)
    _, apply = jbuild_model(jcfg)
    with jbasic_hash_dropout():
        want = np.asarray(apply(params, {m: jnp.asarray(v)
                                         for m, v in inputs.items()},
                                jnp.asarray(mask), rng=key))
    module = load_jax_params(build_model(cfg), params)
    with torch.no_grad():
        got = module({m: torch.from_numpy(v) for m, v in inputs.items()},
                     torch.from_numpy(mask),
                     seeds=jax_family_seeds(key, cfg, mask.shape[1])).numpy()
    valid = mask[..., 0] > 0
    np.testing.assert_allclose(got[valid], want[valid], atol=ATOL)
