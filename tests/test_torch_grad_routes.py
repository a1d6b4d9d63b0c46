"""Dropout-free training, float32 on the CPU: a call that needs gradients and
carries no dropout seeds takes the training kernels at p = 0 on the card
(kernels 3 and 4 or 5 for the encoders, 6 and 7 for the MFN), since the eval
kernels A and B have no backward and raise under autograd; eval under
`torch.no_grad()` or `torch.inference_mode()` keeps them.

The routes are checked by sending CPU tensors down the card's routes with
stand-ins that record the calls.  The gradients are checked the same way,
the training wrappers running their plain versions on the CPU, against
`jax.value_and_grad` of the JAX package's `apply(..., rng=None)` for the MFT
and B3-MFN A+V+L (two encoder layers, full encoder and MFN widths, narrow
modality widths, B=2, T=6), within tests/test_torch_train.py's
tolerances."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from make_goldens import SMALL_DIMS
from test_torch_train import _grad_errors

from multimodal_transformer_tpu.models import build_model as jbuild_model
from multimodal_transformer_tpu.models import default_config as jdefault_config
from multimodal_transformer_tpu_torch import build_model, default_config
from multimodal_transformer_tpu_torch.models import families, frontend
from multimodal_transformer_tpu_torch.ops import attention, dispatch, mfn_core
from multimodal_transformer_tpu_torch.ops.cuda import encoder as enc_k
from multimodal_transformer_tpu_torch.ops.cuda import encoder_train
from multimodal_transformer_tpu_torch.ops.cuda import mfn as mfn_k
from multimodal_transformer_tpu_torch.utils import prng
from multimodal_transformer_tpu_torch.utils.params import (export_params,
                                                           flatten_tree,
                                                           load_jax_params)
from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401


AVL = ("acoustic", "image", "linguistic")


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.parametrize("T,backward,want", [
    (160, "perlayer", "train"), (160, "stack", "train_stack"),
    (1120, "perlayer", "train"), (1120, "stack", "train_stack")])
def test_encoder_route_needing_gradients_trains(T, backward, want):
    assert dispatch.encoder_route(True, T, "key_query", False, backward,
                                  needs_grad=True) == want
    assert dispatch.encoder_route(True, T, "key_query", False, backward,
                                  needs_grad=False) == (
        "flash" if T > dispatch.FLASH_ATTN_MIN_T else "fused")
    assert dispatch.encoder_route(True, T, "query", False, backward,
                                  needs_grad=True) == "plain"
    assert dispatch.encoder_route(False, T, "key_query", False, backward,
                                  needs_grad=True) == "plain"


def test_needs_grad_follows_grad_mode():
    w = torch.ones(2, requires_grad=True)
    x = torch.ones(2)
    assert dispatch.needs_grad(x, w) and not dispatch.needs_grad(x)
    with torch.no_grad():
        assert not dispatch.needs_grad(x, w)
    with torch.inference_mode():
        assert not dispatch.needs_grad(x, w)


@pytest.fixture
def encoder_case():
    gen = torch.Generator().manual_seed(0)
    enc = load_jax_params(attention.Encoder(16, 8, 2),
                          attention.encoder_init(prng.key(0), 16, 8, 2))
    x = torch.randn(2, 5, 16, generator=gen)
    mask = torch.ones(2, 5, 1)
    mask[1, 3:] = 0
    return enc, x, mask


@pytest.mark.parametrize("T", [5, 520])
def test_encoder_stack_routes_by_grad_mode(encoder_case, monkeypatch, T):
    """On the card's routes: no_grad and inference_mode take kernel A (or
    the flash route past T = 512); grad mode takes kernels 3/4 at p = 0 with
    an all-zero seed table, at every T."""
    enc, _, _ = encoder_case
    x = torch.randn(2, T, 16)
    mask = torch.ones(2, T, 1)
    calls = []
    monkeypatch.setattr(attention, "use_kernel", lambda t: True)
    monkeypatch.setattr(enc_k, "encoder_stack_fused",
                        lambda enc, x, mask, h: calls.append("fused") or x)
    monkeypatch.setattr(attention, "encoder_stack_flash",
                        lambda enc, x, mask, h: calls.append("flash") or x)

    def train(enc, x, mask, *, h, p, seeds, backward, hash4=False):
        calls.append(("train", p, seeds.tolist(), backward))
        return x

    monkeypatch.setattr(encoder_train, "encoder_stack_train", train)
    eval_route = "flash" if T > dispatch.FLASH_ATTN_MIN_T else "fused"
    with torch.no_grad():
        attention.encoder_stack(enc, x, mask, h=2, mask_mode="key_query")
    with torch.inference_mode():
        attention.encoder_stack(enc, x, mask, h=2, mask_mode="key_query")
    assert calls == [eval_route, eval_route]
    calls.clear()
    for backward in ("perlayer", "stack"):
        attention.encoder_stack(enc, x, mask, h=2, mask_mode="key_query",
                                backward=backward)
    zeros = [[0] * 4] * 2
    assert calls == [("train", 0.0, zeros, "perlayer"),
                     ("train", 0.0, zeros, "stack")]


def test_mfn_states_routes_by_grad_mode(monkeypatch):
    gen = torch.Generator().manual_seed(1)
    dims = {m: 8 for m in AVL}
    mfn = load_jax_params(mfn_core.MFN(AVL, dims, 1),
                          mfn_core.mfn_init(prng.key(1), AVL, dims, 1))
    inputs = {m: torch.randn(2, 4, 8, generator=gen) for m in AVL}
    calls = []
    monkeypatch.setattr(mfn_core, "use_kernel", lambda t: True)
    monkeypatch.setattr(mfn_core, "mfn_scan_fused", lambda *a: (
        calls.append("kernel B") or mfn_k.mfn_scan_fused_plain(*a)))

    def train(xps, whhs, gates, seeds, ps):
        calls.append(("train", seeds.tolist(), ps))
        return mfn_k.mfn_scan_fused_plain(xps, whhs, gates)

    monkeypatch.setattr(mfn_core, "mfn_states_train", train)
    with torch.no_grad():
        mfn_core.mfn_states(mfn, inputs)
    with torch.inference_mode():
        mfn_core.mfn_states(mfn, inputs)
    mfn_core.mfn_states(mfn, inputs)
    mfn_core.mfn_states(mfn, inputs, plain=True)
    assert calls == ["kernel B", "kernel B",
                     ("train", [[0, 0]] * 4, (0.0, 0.0))]


def test_eval_kernels_refuse_autograd_on_the_card(encoder_case, monkeypatch):
    """Kernels A and B, called directly as if on the card with a parameter
    that requires grad, raise before they build or launch."""
    enc, x, mask = encoder_case
    monkeypatch.setattr(enc_k, "use_kernel", lambda t: True)
    monkeypatch.setattr(mfn_k, "use_kernel", lambda t: True)
    with pytest.raises(RuntimeError, match="no backward"):
        enc_k.encoder_stack_fused(enc, x, mask, h=2)
    mfn = mfn_core.MFN(AVL, {m: 8 for m in AVL}, 1)
    xps = mfn_core.hoisted_inputs(mfn, {m: torch.randn(2, 3, 8) for m in AVL})
    whhs = [getattr(mfn, f"lstm_{m}").weight_hh for m in AVL]
    with pytest.raises(RuntimeError, match="no backward"):
        mfn_k.mfn_scan_fused(xps, whhs, mfn.gate_tensors())


@pytest.mark.parametrize("family", ["MFT", "B3-MFN"])
def test_seeds_free_grads_match_jax(family, monkeypatch):
    """jax.value_and_grad of apply(rng=None) against the port's autograd on
    the card's routes: the encoders through kernels 3/4 at p = 0, the MFN
    through kernels 6/7 at p = 0 (their plain versions on the CPU)."""
    cfg = default_config(family, AVL, mask_mode="key_query")
    object.__setattr__(cfg, "mod_dimension", dict(SMALL_DIMS))
    jcfg = jdefault_config(family, AVL, mask_mode="key_query")
    object.__setattr__(jcfg, "mod_dimension", dict(SMALL_DIMS))
    # two encoder layers: the JAX apply follows the parameter tree's depth
    monkeypatch.setattr(families, "ENCODER_LAYERS", 2)
    module = build_model(cfg, seed=7)
    params = export_params(module)
    B, T = 2, 6
    rs = np.random.RandomState(8)
    frames = {"acoustic": 3, "image": 2, "linguistic": 4}
    data = {m: rs.randn(B, T, frames[m], SMALL_DIMS[m]).astype(np.float32)
            for m in AVL}
    target = rs.randn(B, T, 1).astype(np.float32)
    mask = np.ones((B, T, 1), np.float32)
    mask[1, 4:] = 0.0
    _, apply = jbuild_model(jcfg)

    def loss_fn(p):
        pred = apply(p, {m: jnp.asarray(v) for m, v in data.items()},
                     jnp.asarray(mask), rng=None)
        return jnp.sum((pred - target) ** 2) / float(mask.sum())

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(params)

    routes = []
    for mod in (attention, mfn_core, frontend):
        monkeypatch.setattr(mod, "use_kernel", lambda t: True)
    stack_train = encoder_train.encoder_stack_train
    monkeypatch.setattr(encoder_train, "encoder_stack_train", lambda *a, **k: (
        routes.append(("encoder", k["p"])) or stack_train(*a, **k)))
    states_train = mfn_core.mfn_states_train
    monkeypatch.setattr(mfn_core, "mfn_states_train", lambda *a: (
        routes.append(("mfn", a[4])) or states_train(*a)))
    pred = module({m: torch.from_numpy(v) for m, v in data.items()},
                  torch.from_numpy(mask))
    loss = ((pred - torch.from_numpy(target)) ** 2).sum() / float(mask.sum())
    loss.backward()

    n_enc = 3 if family == "MFT" else 0
    assert routes == [("encoder", 0.0)] * n_enc + [("mfn", (0.0, 0.0))]
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-5)
    got = {k: v.grad.numpy() for k, v in module.named_parameters()}
    want = {k: np.asarray(v) for k, v in flatten_tree(want_grads).items()}
    assert set(got) == set(want)
    assert _grad_errors(got, want) <= 1.0
