"""The port's legacy LSTM heads (models/legacy_lstm.py) against the JAX
package's `multi_ed_lstm_apply` / `multi_ar_lstm_apply`, float32 on the CPU,
the JAX parameters carried across with `load_jax_params` (the learned
initial states set to random values, so that they count):

  * eval forwards of MultiEDLSTM and MultiARLSTM at B=3, T=12, embed 16,
    h 32 (AR at ar_order 1 and 3) and at the default widths (embed 128,
    h 512) with T=8, a padded row in the mask: max abs <= 1e-5;
  * MultiARLSTM teacher-forced on a target, the same limit;
  * with `rng` given: the embed dropout's keep mask bit for bit (the seed
    that JAX derives from split(rng, 1)[0], through DropoutSeeds.embed),
    and the dropped forwards within 1e-5;
  * loss and every parameter's gradient against `jax.value_and_grad`, in
    training (dropout on) for ED, AR teacher-forced and AR autoregressive
    (whose history is detached, JAX's stop_gradient): loss within 1e-5
    relative, each gradient within 1e-4 relative L2 + 1e-6;
  * the families smoke (`python -m multimodal_transformer_tpu_torch.models.
    families`) on the synthetic fixture with the JAX smoke's weights
    carried across prints the JAX `__main__`'s valences, line for line.
"""

import contextlib
import functools
import io
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_transformer_tpu.models import legacy_lstm as jlegacy
from multimodal_transformer_tpu.ops import basic as jbasic
from multimodal_transformer_tpu_torch.models import families
from multimodal_transformer_tpu_torch.models.legacy_lstm import (MultiARLSTM,
                                                                 MultiEDLSTM)
from multimodal_transformer_tpu_torch.ops.basic import hash_keep_mask
from multimodal_transformer_tpu_torch.ops.seeds import DropoutSeeds
from multimodal_transformer_tpu_torch.utils.params import (flatten_tree,
                                                           load_jax_params)
from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401

ATOL = 1e-5
LOSS_RTOL, GRAD_RTOL, GRAD_FLOOR = 1e-5, 1e-4, 1e-6
WE = 20  # window_embed_size

SMALL = dict(embed_dim=16, h_dim=32)


def _ed_apply(params, x, mask, rng=None):
    return jax.jit(jlegacy.multi_ed_lstm_apply)(params, jnp.asarray(x),
                                                jnp.asarray(mask), rng=rng)


def _ar_apply(params, x, mask, rng=None, target=None, ar_order=1):
    fn = jax.jit(functools.partial(jlegacy.multi_ar_lstm_apply,
                                   ar_order=ar_order))
    return fn(params, jnp.asarray(x), jnp.asarray(mask), rng=rng,
              target=None if target is None else jnp.asarray(target))


def _ed(seed, **kw):
    params = jlegacy.multi_ed_lstm_init(jax.random.PRNGKey(seed), WE, **kw)
    rs = np.random.RandomState(seed)
    for k in ("enc_h0", "enc_c0", "dec_h0", "dec_c0"):
        params[k] = jnp.asarray(0.5 * rs.randn(*params[k].shape), jnp.float32)
    return params, load_jax_params(MultiEDLSTM(WE, **kw), params)


def _ar(seed, **kw):
    params = jlegacy.multi_ar_lstm_init(jax.random.PRNGKey(seed), WE, **kw)
    return params, load_jax_params(MultiARLSTM(WE, **kw), params)


def _inputs(B, T, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(B, T, WE).astype(np.float32)
    mask = np.ones((B, T, 1), np.float32)
    mask[1, T - 3:] = 0
    target = (0.3 * rs.randn(B, T, 1)).astype(np.float32)
    return x, mask, target


def _seeds(rng) -> DropoutSeeds:
    r = jax.random.split(rng, 1)[0]
    return DropoutSeeds({}, embed=int(np.uint32(jbasic.hash_seed(r))))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, atol=ATOL):
    err = float(np.abs(got.detach().numpy() - np.asarray(want)).max())
    assert err <= atol, err


def test_state_dict_keys_equal_jax_tree():
    for init, cls, kw in ((jlegacy.multi_ed_lstm_init, MultiEDLSTM, {}),
                          (jlegacy.multi_ar_lstm_init, MultiARLSTM,
                           {"ar_order": 2})):
        shapes = jax.eval_shape(lambda k: init(k, WE, **kw),
                                jax.random.PRNGKey(0))
        want = {k: tuple(v.shape) for k, v in flatten_tree(shapes).items()}
        got = {k: tuple(v.shape) for k, v in cls(WE, **kw).state_dict()
               .items()}
        assert got == want


@pytest.mark.parametrize("widths,T", [(SMALL, 12), ({}, 8)])
def test_ed_eval_forward(widths, T):
    params, module = _ed(1, **widths)
    x, mask, _ = _inputs(3, T)
    want = _ed_apply(params, x, mask)
    with torch.no_grad():
        got = module(_t(x), _t(mask))
    assert got.shape == (3, T, 1)
    _close(got, want)


@pytest.mark.parametrize("widths,T,ar_order", [(SMALL, 12, 1), (SMALL, 12, 3),
                                               ({}, 8, 1)])
def test_ar_eval_and_teacher_forced_forward(widths, T, ar_order):
    params, module = _ar(2, ar_order=ar_order, **widths)
    x, mask, target = _inputs(3, T, seed=1)
    for tgt in (None, target):
        want = _ar_apply(params, x, mask, target=tgt, ar_order=ar_order)
        with torch.no_grad():
            got = module(_t(x), _t(mask),
                         target=None if tgt is None else _t(tgt))
        _close(got, want)
    # teacher forcing is not the AR recurrence on these weights
    assert not np.allclose(np.asarray(want), np.asarray(
        _ar_apply(params, x, mask, ar_order=ar_order)), atol=1e-3)


def test_dropout_masks_equal_jax():
    rng = jax.random.PRNGKey(11)
    x, mask, target = _inputs(3, 12, seed=2)
    seeds = _seeds(rng)
    # the keep mask of the [B, T, window_embed] site, bit for bit
    want = np.asarray(jbasic.dropout(jnp.asarray(x),
                                     jax.random.split(rng, 1)[0], 0.1))
    idx = torch.arange(x.size, dtype=torch.int64).view(x.shape)
    keep = hash_keep_mask(seeds.embed, idx, 0.1).numpy()
    assert np.array_equal(keep, want != 0) and 0 < (~keep).sum() < x.size
    ed_params, ed = _ed(3, **SMALL)
    ar_params, ar = _ar(4, **SMALL)
    with torch.no_grad():
        _close(ed(_t(x), _t(mask), seeds=seeds),
               _ed_apply(ed_params, x, mask, rng=rng))
        for tgt in (None, target):
            _close(ar(_t(x), _t(mask), seeds=seeds,
                      target=None if tgt is None else _t(tgt)),
                   _ar_apply(ar_params, x, mask, rng=rng, target=tgt))
    assert ed.dropout_sites().embed_width == WE


def _loss(pred, mask, y):
    return (((pred - y) * mask) ** 2).sum() / mask.sum()


@pytest.mark.parametrize("head,teacher", [("ed", False), ("ar", True),
                                          ("ar", False)])
def test_loss_and_grads_equal_jax(head, teacher):
    rng = jax.random.PRNGKey(5)
    x, mask, target = _inputs(3, 12, seed=3)
    if head == "ed":
        params, module = _ed(6, **SMALL)
        apply = jlegacy.multi_ed_lstm_apply
        kw = {}
    else:
        params, module = _ar(7, ar_order=2, **SMALL)
        apply = jlegacy.multi_ar_lstm_apply
        kw = {"ar_order": 2}
    tgt = jnp.asarray(target) if teacher else None

    def loss_fn(p):
        if tgt is not None:
            kw["target"] = tgt
        pred = apply(p, jnp.asarray(x), jnp.asarray(mask), rng=rng, **kw)
        return _loss(pred, jnp.asarray(mask), jnp.asarray(target))

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    module.train()
    pred = module(_t(x), _t(mask), seeds=_seeds(rng),
                  **({"target": _t(target)} if teacher else {}))
    loss = _loss(pred, _t(mask), _t(target))
    loss.backward()
    assert abs(loss.item() - float(want_loss)) <= LOSS_RTOL * abs(
        float(want_loss))
    want = flatten_tree(want_grads)
    named = dict(module.named_parameters())
    assert set(named) == set(want)
    for name, p in named.items():
        g, w = p.grad.numpy(), np.asarray(want[name])
        err = np.linalg.norm(g - w)
        assert err <= GRAD_RTOL * np.linalg.norm(w) + GRAD_FLOOR, (name, err)
    if head == "ed":  # the learned initial states get their gradients
        assert float(named["dec_h0"].grad.abs().sum()) > 0


def test_families_smoke_prints_the_jax_valences(tmp_path, monkeypatch):
    """The JAX smoke run (`runpy` of models/families.py as __main__) and
    `legacy_ar_smoke` on the same fixture and weights print the same
    valences."""
    from multimodal_transformer_tpu.data import generate_synthetic_send
    from multimodal_transformer_tpu.models import default_config

    data_dir = str(tmp_path / "send")
    generate_synthetic_send(data_dir, {"Train": 2}, duration_s=20.0, seed=3)
    monkeypatch.setattr(sys, "argv", ["families", "--dir", data_dir,
                                      "--subset", "Train"])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        runpy.run_module("multimodal_transformer_tpu.models.families",
                         run_name="__main__")
    want = out.getvalue().split("Predicted valences:\n")[1].split()

    cfg = default_config("B3-MFN", ("acoustic", "emotient"))
    total = sum(cfg.mod_dimension[m] for m in cfg.modalities)
    params = jlegacy.multi_ar_lstm_init(jax.random.PRNGKey(0), total)
    module = load_jax_params(MultiARLSTM(total), params)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        vals = families.legacy_ar_smoke(module, data_dir, "Train",
                                        device="cpu")
    got = out.getvalue().split("Predicted valences:\n")[1].split()
    assert len(got) == len(want) == len(vals) > 10
    assert got == want
    assert np.all(np.isfinite(vals))
