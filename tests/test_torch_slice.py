"""Port parity for the whole slice, float32 on the CPU, atol 1e-4 on valid
(mask == 1) positions: the MFT A+V+L forward against the JAX model in both
mask modes, against the committed `mft_avl` golden, and `ValencePredictor.
predict_padded` against the JAX predictor."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from make_goldens import GOLDEN_DIR, SMALL_DIMS

from multimodal_transformer_tpu.models import build_model as jbuild_model
from multimodal_transformer_tpu.models import default_config as jdefault_config
from multimodal_transformer_tpu.serve import ValencePredictor as JPredictor
from multimodal_transformer_tpu_torch import (ValencePredictor, build_model,
                                              default_config)
from multimodal_transformer_tpu_torch.utils.params import (export_params,
                                                           flatten_tree,
                                                           load_jax_params)
from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401


AVL = ("acoustic", "image", "linguistic")
ATOL = 1e-4


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _configs(mask_mode):
    jcfg = jdefault_config("MFT", AVL, mask_mode=mask_mode)
    object.__setattr__(jcfg, "mod_dimension", dict(SMALL_DIMS))
    cfg = default_config("MFT", AVL, mask_mode=mask_mode)
    object.__setattr__(cfg, "mod_dimension", dict(SMALL_DIMS))
    return jcfg, cfg


def _port(cfg, params):
    return load_jax_params(build_model(cfg), params).eval()


def _inputs(seed, B=2, W=7, Fr=4):
    rs = np.random.RandomState(seed)
    inputs = {m: rs.randn(B, W, Fr, SMALL_DIMS[m]).astype(np.float32)
              for m in AVL}
    mask = np.ones((B, W, 1), np.float32)
    mask[1, 5:] = 0.0
    return inputs, mask


def _run_port(module, inputs, mask):
    with torch.no_grad():
        return module({m: torch.from_numpy(v) for m, v in inputs.items()},
                      torch.from_numpy(mask)).numpy()


@pytest.mark.parametrize("mask_mode", ["query", "key_query"])
def test_mft_forward_matches_jax(mask_mode):
    jcfg, cfg = _configs(mask_mode)
    init, apply = jbuild_model(jcfg)
    params = jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(7)))
    inputs, mask = _inputs(11)
    want = np.asarray(apply(params, {m: jnp.asarray(v)
                                     for m, v in inputs.items()},
                            jnp.asarray(mask)))
    got = _run_port(_port(cfg, params), inputs, mask)
    valid = mask[..., 0] > 0
    np.testing.assert_allclose(got[valid], want[valid], atol=ATOL)
    assert (got[~valid] == 0).all()


def test_mft_matches_golden():
    """tests/goldens/mft_avl.npz, with the params and inputs of
    make_goldens.build_case (query mode)."""
    jcfg, cfg = _configs("query")
    init, _ = jbuild_model(jcfg)
    params = jax.tree_util.tree_map(np.asarray,
                                    init(jax.random.PRNGKey(1234)))
    inputs, mask = _inputs(99)
    want = np.load(f"{GOLDEN_DIR}/mft_avl.npz")["out"]
    got = _run_port(_port(cfg, params), inputs, mask)
    valid = mask[..., 0] > 0
    np.testing.assert_allclose(got[valid], want[valid], atol=ATOL)


def test_export_params_round_trips():
    jcfg, cfg = _configs("key_query")
    init, _ = jbuild_model(jcfg)
    params = jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(2)))
    tree = export_params(_port(cfg, params))
    assert jax.tree_util.tree_structure(tree) == \
        jax.tree_util.tree_structure(params)
    a, b = flatten_tree(tree), flatten_tree(params)
    assert all(np.array_equal(a[k], b[k]) for k in b)


def test_predictor_matches_jax_predictor():
    """6 videos over 2 buckets (time_multiple=8, batch_size=4)."""
    jcfg, cfg = _configs("key_query")
    init, _ = jbuild_model(jcfg)
    params = jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(5)))
    lens = [3, 8, 5, 11, 14, 7]
    rs = np.random.RandomState(3)
    data = {m: rs.randn(6, 14, 4, SMALL_DIMS[m]).astype(np.float32)
            for m in AVL}
    want = JPredictor(jcfg, params, batch_size=4, time_multiple=8,
                      bf16=False).predict_padded(data, lens)
    pred = ValencePredictor(cfg, _port(cfg, params), device="cpu",
                            batch_size=4, time_multiple=8, bf16=False)
    got = pred.predict_padded(data, lens)
    assert [len(g) for g in got] == lens
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, w, atol=ATOL)
    assert pred.warmup(16, frames={m: 4 for m in AVL}) == 2
