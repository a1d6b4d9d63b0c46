"""Port parity for the Engine's evaluation, float32 on the CPU.

The JAX `Engine` and the port's `Engine` evaluate the same MFT A+V+L
(small modality widths, full encoder and MFN widths, "key_query") with the
JAX Engine's parameters carried over by `load_jax_params`, on 6 videos of
9 to 520 windows:

  * `evaluate_per_video` (one video at a time, in a shuffled order on both
    sides): the predictions within 2e-5 (float32 forwards summing in
    another order through 6 encoder layers, the MFN and the head), each
    video's CCC and Pearson r, the loss and the stats within 1e-4, the same
    best video, and an `Evaluation` line of the same text up to the last
    digits of its numbers;
  * `evaluate_batched` (length buckets of 32 windows, batches of 4, so two
    rows of each batch are fillers whose keys are all masked): CCCs, loss
    and stats within 1e-4, and within 1e-4 of the per-video CCCs and loss;
    with eval_dtype=bf16 on both sides, CCCs within 5e-4 (see the test);
  * the routes: with the CPU tensors routed as CUDA ones would be, the two
    videos of 520 windows take the flash route (18 attention calls each:
    3 encoders x 6 layers, and 18 for their one bucket of 544) and the
    others kernel A (3 calls per video or batch);
  * `evaluate_batched` refuses "query" mode as the JAX Engine does.
"""

import logging
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from make_goldens import SMALL_DIMS

from multimodal_transformer_tpu.engine import train_engine as jtrain_engine
from multimodal_transformer_tpu.models import default_config as jdefault_config
from multimodal_transformer_tpu_torch import default_config
from multimodal_transformer_tpu_torch.engine import Engine
from multimodal_transformer_tpu_torch.ops import attention
from multimodal_transformer_tpu_torch.ops.cuda import encoder as enc_k
from multimodal_transformer_tpu_torch.ops.cuda import flash_attention as fa_k
from multimodal_transformer_tpu_torch.utils.params import load_jax_params
from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401


AVL = ("acoustic", "image", "linguistic")
LENS = [520, 9, 300, 9, 520, 300]
TOL = 1e-4


class Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _logger(name):
    log = logging.getLogger(f"test_torch_eval.{name}")
    log.setLevel(logging.INFO)
    log.propagate = False
    log.handlers = [Lines()]
    return log


def _configs(mask_mode):
    jcfg = jdefault_config("MFT", AVL, mask_mode=mask_mode)
    cfg = default_config("MFT", AVL, mask_mode=mask_mode)
    for c in (jcfg, cfg):
        object.__setattr__(c, "mod_dimension", dict(SMALL_DIMS))
    return jcfg, cfg


@pytest.fixture(scope="module")
def engines():
    torch.backends.cuda.matmul.allow_tf32 = False
    jcfg, cfg = _configs("key_query")
    jeng = jtrain_engine.Engine(jcfg, seed=3, logger=_logger("jax"))
    eng = Engine(cfg, device="cpu", logger=_logger("port"))
    load_jax_params(eng.module, jeng.params)
    rs = np.random.RandomState(8)
    W = max(LENS)
    data = {m: rs.randn(len(LENS), W, 3, SMALL_DIMS[m]).astype(np.float32)
            for m in AVL}
    # targets are zero past each video's length, as the SENDv1 reader pads
    target = rs.randn(len(LENS), W).astype(np.float32) * (
        np.arange(W)[None, :] < np.array(LENS)[:, None])
    return jcfg, cfg, jeng, eng, (data, target, LENS)


@pytest.fixture
def routed(monkeypatch):
    """CPU tensors take the CUDA encoder routes; the wrappers check their
    arguments as on the card, record their calls and run their plain
    versions."""
    calls = {"flash": 0, "fused": 0}
    monkeypatch.setattr(attention, "use_kernel", lambda t: True)

    def flash(*a):
        fa_k._check(*a)  # what the kernel would take
        calls["flash"] += 1
        return fa_k.flash_attention_masked_plain(*a)

    def fused(*a, **k):
        calls["fused"] += 1
        return enc_k.encoder_stack_fused_plain(*a, **k)

    monkeypatch.setattr(fa_k, "flash_attention_masked", flash)
    monkeypatch.setattr(enc_k, "encoder_stack_fused", fused)
    return calls


def _same_text(a: str, b: str):
    """The two lines agree in text; their numbers within TOL."""
    assert re.sub(r"\d", "#", a) == re.sub(r"\d", "#", b), (a, b)
    na = [float(x) for x in re.findall(r"-?\d+\.\d+", a)]
    nb = [float(x) for x in re.findall(r"-?\d+\.\d+", b)]
    np.testing.assert_allclose(na, nb, atol=TOL)


def test_evaluate_per_video_matches_jax(engines, routed):
    _, _, jeng, eng, (data, target, lens) = engines
    want = jeng.evaluate_per_video(data, target, lens,
                                   shuffle_rng=np.random.RandomState(1))
    got = eng.evaluate_per_video(data, target, lens,
                                 shuffle_rng=np.random.RandomState(1))
    cccs, preds, actuals, loss, stats, best = got
    assert len(cccs) == len(preds) == len(actuals) == len(lens)
    for g, w in zip(preds, want[1]):
        np.testing.assert_allclose(g, w, atol=2e-5)
    assert actuals == want[2]
    np.testing.assert_allclose(cccs, want[0], atol=TOL)
    assert loss == pytest.approx(want[3], abs=TOL)
    assert set(stats) == set(want[4])
    for k in stats:
        assert stats[k] == pytest.approx(want[4][k], abs=TOL), k
    assert best[2] == want[5][2]
    np.testing.assert_allclose(best[0], want[5][0], atol=2e-5)
    line, jline = (logging.getLogger(f"test_torch_eval.{s}").handlers[0]
                   .lines[-1] for s in ("port", "jax"))
    assert line.startswith("Evaluation\tLoss: ")
    assert line == ('Evaluation\tLoss: {:2.5f}\tCorr: {:0.3f}\tCCC: {:0.9f}'
                    .format(loss, stats["corr"], stats["ccc"]))
    _same_text(line, jline)
    n_long = sum(n > 512 for n in lens)
    assert routed == {"flash": 18 * n_long, "fused": 3 * (len(lens) - n_long)}


def test_evaluate_batched_matches_jax(engines, routed):
    _, _, jeng, eng, (data, target, lens) = engines
    want = jeng.evaluate_batched(data, target, lens, batch_size=4)
    cccs, loss, stats = eng.evaluate_batched(data, target, lens,
                                             batch_size=4)
    np.testing.assert_allclose(cccs, want[0], atol=TOL)
    assert loss == pytest.approx(want[1], abs=TOL)
    assert set(stats) == set(want[2])
    for k in stats:
        assert stats[k] == pytest.approx(want[2][k], abs=TOL), k
    per_video = eng.evaluate_per_video(data, target, lens)
    np.testing.assert_allclose(cccs, per_video[0], atol=TOL)
    assert loss == pytest.approx(per_video[3], abs=TOL)
    # buckets 32, 320 and 544 of one batch each; the per-video pass after
    assert routed == {"flash": 18 + 18 * 2, "fused": 3 * 2 + 3 * 4}


def test_evaluate_batched_bf16_matches_jax(engines):
    """eval_dtype=bf16 on both sides: the weights and activations rounded to
    bf16 (2^-9 relative) move these CCCs, of ~1e-2 at this random init, by
    ~1e-4 from the float32 ones; both frameworks round at their own
    points, so each side is held within 5e-4 of the other and of float32."""
    jcfg, cfg, jeng32, eng32, (data, target, lens) = engines
    jeng = jtrain_engine.Engine(jcfg, seed=3, eval_dtype=jnp.bfloat16)
    jeng.params = jeng32.params
    eng = Engine(cfg, device="cpu", eval_dtype=torch.bfloat16)
    eng.module.load_state_dict(eng32.module.state_dict())
    want = jeng.evaluate_batched(data, target, lens, batch_size=4)
    cccs, loss, _ = eng.evaluate_batched(data, target, lens, batch_size=4)
    fp32 = eng32.evaluate_batched(data, target, lens, batch_size=4)
    np.testing.assert_allclose(cccs, want[0], atol=5e-4)
    np.testing.assert_allclose(cccs, fp32[0], atol=5e-4)
    assert loss == pytest.approx(want[1], rel=1e-3)


def test_evaluate_batched_refuses_query_mode():
    jcfg, cfg = _configs("query")
    eng = Engine(cfg, device="cpu")
    jeng = jtrain_engine.Engine.__new__(jtrain_engine.Engine)
    jeng.cfg = jcfg
    args = ({m: np.zeros((1, 4, 3, SMALL_DIMS[m]), np.float32) for m in AVL},
            np.zeros((1, 4), np.float32), [4])
    with pytest.raises(ValueError) as want:
        jeng.evaluate_batched(*args)
    with pytest.raises(ValueError) as got:
        eng.evaluate_batched(*args)
    assert str(got.value) == str(want.value)
