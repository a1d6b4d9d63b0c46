"""`python -m multimodal_transformer_tpu_torch.train` on the CPU
(`--device cpu`), on the JAX CLI tests' synthetic fixture (3/2/2 videos,
seed 7; tests/test_cli.py), and across the two CLIs:

  * train -> `--eval` -> `--perf` on B2-Trans V+L (tests/test_cli.py:36),
    `--resident_train` and `--test --fast_eval` (:69), the PredSave golden
    video (:86), the B1 window lift (:104), `--resume` (:193, on the port's
    `.state`), SIGTERM preemption (:207), `--visualize` refused and
    `--device cuda` without a card refused;
  * the port's `.pth` evaluated by the JAX `train.py --eval --load` gives
    the port's CCC within 1e-4;
  * a JAX-written `.ckpt` swept by the port's `--perf` gives the JAX
    PerfSave CCCs within 1e-4;
  * `ValencePredictor.from_checkpoint` on a `.pth` and a `.ckpt` gives the
    JAX predictor's traces (float32) within 1e-5.
"""

import csv
import logging
import os
import signal
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import train as jcli  # noqa: E402
from multimodal_transformer_tpu.engine import checkpoint as jcheckpoint  # noqa: E402
from multimodal_transformer_tpu_torch import train as cli  # noqa: E402
from multimodal_transformer_tpu_torch.data import generate_synthetic_send  # noqa: E402
from multimodal_transformer_tpu_torch.engine.train_engine import Engine  # noqa: E402
from multimodal_transformer_tpu_torch.models import default_config  # noqa: E402
from multimodal_transformer_tpu_torch.utils.params import unflatten_tree  # noqa: E402
from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    data_dir = d / "SENDv1-data"
    generate_synthetic_send(str(data_dir), {"Train": 3, "Valid": 2,
                                            "Test": 2},
                            duration_s=18.0, seed=7)
    return d


def _paths(workdir):
    return ["--data_dir", str(workdir / "SENDv1-data"),
            "--save_dir", str(workdir / "ModelSave"),
            "--pred_save_dir", str(workdir / "PredSave"),
            "--perf_save_dir", str(workdir / "PerfSave"),
            "--log_file", str(workdir / "train_cnn.log")]


def _args(workdir, extra):
    return cli.build_arg_parser().parse_args(
        _paths(workdir) + ["--device", "cpu"] + extra)


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


@pytest.fixture(scope="module")
def trained(workdir):
    """B2-Trans V+L trained 2 epochs: its .pth and .pth.state."""
    best = cli.main(_args(workdir, ["--family", "B2-Trans", "--epochs", "2",
                                    "--lr", "1e-3"]))
    assert np.isfinite(best)
    log_text = (workdir / "train_cnn.log").read_text()
    assert "CCC_STATS\tSINGLE_BEST:" in log_text
    assert "Evaluation\tLoss:" in log_text
    return workdir / "ModelSave" / "B2-Trans" / "B2-Trans-VL.pth"


def test_train_eval_perf_cycle(workdir, trained):
    assert trained.exists()
    stats = cli.main(_args(workdir, ["--family", "B2-Trans", "--eval",
                                     "--load", str(trained)]))
    assert np.isfinite(stats["ccc"])
    cli.main(_args(workdir, ["--perf", "--model_save",
                             str(workdir / "ModelSave" / "B2-Trans")]))
    rows = _rows(workdir / "PerfSave" / "B2-Trans.csv")
    assert rows[0] == ["Model", "Combination", "VidID", "Set", "CCC"]
    assert {r[3] for r in rows[1:]} == {"Train", "Valid", "Test"}
    assert {(r[0], r[1]) for r in rows[1:]} == {("B2-Trans", "LV")}
    assert len(rows) == 1 + 7  # 3 train + 2 valid + 2 test videos


def test_port_pth_in_the_jax_cli(workdir, trained):
    """The JAX CLI evaluates the port's .pth (convert_pth) per video to the
    port's CCC."""
    want = cli.main(_args(workdir, ["--family", "B2-Trans", "--eval",
                                    "--load", str(trained)]))
    got = jcli.main(jcli.build_arg_parser().parse_args(
        _paths(workdir) + ["--family", "B2-Trans", "--eval",
                           "--load", str(trained)]))
    assert abs(got["ccc"] - want["ccc"]) <= 1e-4
    assert abs(got["ccc_std"] - want["ccc_std"]) <= 1e-4


def test_jax_ckpt_in_the_port_perf_sweep(workdir, trained):
    """A .ckpt written by the JAX package, swept by both CLIs' --perf: the
    same rows, CCCs within 1e-4."""
    cfg, state = cli.load_model(str(trained), "B2-Trans")
    tree = jax.tree_util.tree_map(jnp.asarray, unflatten_tree(state))
    jdir = workdir / "JaxSave"
    jcheckpoint.save_checkpoint(cfg.modalities, cfg.mod_dimension,
                                cfg.window_size, tree,
                                str(jdir / "B2-Trans-VL.ckpt"))
    extra = ["--perf", "--model_save", str(jdir)]
    jcli.main(jcli.build_arg_parser().parse_args(
        _paths(workdir) + extra + ["--perf_save_dir",
                                   str(workdir / "PerfJax")]))
    cli.main(_args(workdir, extra))
    want = _rows(workdir / "PerfJax" / "JaxSave.csv")
    got = _rows(workdir / "PerfSave" / "JaxSave.csv")
    assert len(got) == len(want) == 8
    assert [r[:4] for r in got] == [r[:4] for r in want]
    assert max(abs(float(g[4]) - float(w[4]))
               for g, w in zip(got[1:], want[1:])) <= 1e-4


def test_predictor_from_checkpoint_equals_jax(workdir, trained):
    """`ValencePredictor.from_checkpoint(...).predict_dataset` on the Test
    split, the port's .pth and the same weights as a JAX .ckpt, against the
    JAX predictor on the .pth, all float32: within 1e-5."""
    from multimodal_transformer_tpu.data import load_send as jload_send
    from multimodal_transformer_tpu.serve import \
        ValencePredictor as JValencePredictor
    from multimodal_transformer_tpu_torch import ValencePredictor
    from multimodal_transformer_tpu_torch.data import load_send

    data_dir = str(workdir / "SENDv1-data")
    mods = ("image", "linguistic")
    jp = JValencePredictor.from_checkpoint(str(trained), "B2-Trans",
                                           bf16=False)
    want = jp.predict_dataset(jload_send(mods, data_dir, "Test",
                                         use_native=False))
    cfg, state = cli.load_model(str(trained), "B2-Trans")
    ckpt = str(workdir / "predictor.ckpt")
    jcheckpoint.save_checkpoint(cfg.modalities, cfg.mod_dimension,
                                cfg.window_size, unflatten_tree(state), ckpt)
    for path in (str(trained), ckpt):
        p = ValencePredictor.from_checkpoint(path, "B2-Trans", device="cpu",
                                             bf16=False)
        assert p.cfg.mask_mode == "key_query"
        got = p.predict_dataset(load_send(mods, data_dir, "Test",
                                          use_native=False))
        assert got.keys() == want.keys() == {"100_1", "101_2"}
        for k in want:
            assert got[k].shape == want[k].shape
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5)


def test_resident_train_and_fast_eval(workdir):
    best = cli.main(_args(workdir, [
        "--family", "B2-Trans", "--epochs", "2", "--lr", "1e-3",
        "--resident_train", "--mask_mode", "key_query",
        "--save_dir", str(workdir / "ModelSaveR")]))
    assert np.isfinite(best)
    ckpt = workdir / "ModelSaveR" / "B2-Trans" / "B2-Trans-VL.pth"
    stats = cli.main(_args(workdir, ["--family", "B2-Trans", "--test",
                                     "--fast_eval", "--load", str(ckpt)]))
    assert np.isfinite(stats["ccc"])
    with pytest.raises(SystemExit, match="requires --mask_mode key_query"):
        cli.main(_args(workdir, ["--family", "B2-Trans", "--epochs", "1",
                                 "--resident_train",
                                 "--save_dir", str(workdir / "ModelSaveQ")]))


def test_eval_writes_pred_save_for_golden_video(workdir, trained,
                                                monkeypatch):
    monkeypatch.setitem(cli.PRED_SAVE_VIDEO, "Valid", "100_1")
    cli.main(_args(workdir, ["--family", "B2-Trans", "--eval",
                             "--load", str(trained)]))
    rows = _rows(workdir / "PredSave" / "B2-Trans100_1.csv")
    assert rows[0] == ["time", "pred", "actual"]
    assert [int(r[0]) for r in rows[1:]] == list(range(len(rows) - 1))
    assert len(rows) > 4


def test_b1_multimodal_window_lift(workdir):
    log = logging.getLogger("test_torch_cli")
    cfg = default_config("B1-LSTM", ("acoustic", "linguistic"))
    lifted = cli.apply_window_override(cfg, None, log)
    assert (lifted.window_size["acoustic"], lifted.window_size["linguistic"],
            lifted.window_size["ratings"]) == (5, 5, 5)
    data_dir = workdir / "SENDv1-data"
    generate_synthetic_send(str(data_dir), {"Train": 3, "Valid": 2,
                                            "Test": 2},
                            duration_s=18.0, seed=7,
                            modalities=("linguistic",),
                            linguistic_variant="bert")
    _, x, y, _ = cli.prepare_data(lifted, str(data_dir), "Train", "bert")
    assert y.shape == (3, 4)
    assert x["acoustic"].shape[:2] == (3, 4)
    assert x["acoustic"].shape[3] == 88 and x["linguistic"].shape[3] == 1024

    best = cli.main(_args(workdir, ["--family", "B1-LSTM", "--comb", "AL",
                                    "--epochs", "1", "--lr", "1e-3"]))
    assert np.isfinite(best)
    ck = torch.load(str(workdir / "ModelSave" / "B1-LSTM" /
                        "B1-LSTM-AL.pth"), weights_only=True)
    assert int(ck["window_size"]["acoustic"]) == 5
    cfg2 = cli.apply_window_override(cfg, "acoustic=10,ratings=5", log)
    assert cfg2.window_size["acoustic"] == 10


def test_resume_and_sigterm_preemption(workdir, monkeypatch):
    """--resume continues from the .state; SIGTERM saves the state at the
    epoch boundary, exits 143 and restores the previous handler."""
    base = ["--family", "B2-Trans", "--lr", "1e-3", "--save_freq", "1",
            "--save_dir", str(workdir / "ModelSaveS")]
    cli.main(_args(workdir, base + ["--epochs", "1"]))
    state = workdir / "ModelSaveS" / "B2-Trans" / "B2-Trans-VL.pth.state"
    assert state.exists()
    cli.main(_args(workdir, base + ["--epochs", "2", "--resume"]))
    log_text = (workdir / "train_cnn.log").read_text()
    assert "Resumed from" in log_text and "at epoch 2" in log_text

    orig_epoch = Engine.train_epoch
    fired = []

    def epoch_then_sigterm(self, *a, **kw):
        out = orig_epoch(self, *a, **kw)
        if not fired:
            fired.append(1)
            signal.raise_signal(signal.SIGTERM)
        return out

    monkeypatch.setattr(Engine, "train_epoch", epoch_then_sigterm)
    before = signal.getsignal(signal.SIGTERM)
    pre = ["--family", "B2-Trans", "--epochs", "4", "--lr", "1e-3",
           "--save_dir", str(workdir / "ModelSaveP")]
    with pytest.raises(SystemExit) as ei:
        cli.main(_args(workdir, pre))
    assert ei.value.code == 143
    assert signal.getsignal(signal.SIGTERM) is before
    assert (workdir / "ModelSaveP" / "B2-Trans" /
            "B2-Trans-VL.pth.state").exists()
    assert "Preempted: state saved" in (workdir / "train_cnn.log").read_text()
    monkeypatch.setattr(Engine, "train_epoch", orig_epoch)
    best = cli.main(_args(workdir, pre + ["--resume", "--epochs", "2"]))
    assert np.isfinite(best)
    assert "at epoch 2" in (workdir / "train_cnn.log").read_text()


@pytest.mark.parametrize("extra,message", [
    (["--device", "cpu", "--visualize", "--eval", "--load", "x.pth"],
     "matplotlib"),
    (["--device", "cuda", "--eval", "--load", "x.pth"], "no CUDA device"),
    (["--device", "cpu", "--family", "B4-GRU"], "unknown --family")])
def test_refused(workdir, extra, message):
    if "cuda" in extra and torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    args = cli.build_arg_parser().parse_args(_paths(workdir) + extra)
    with pytest.raises(SystemExit, match=message) as ei:
        cli.main(args)
    assert ei.value.code != 0
