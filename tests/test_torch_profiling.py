"""The port's profiling utilities (engine/profiling.py) and its last two
artifact writers (engine/csv_io.py) against the JAX package's:

  * `StepTimer.summary()` has the JAX class's keys and values for the same
    samples, and times the steps it wraps;
  * `trace` writes a non-empty Chrome trace on the CPU, also when the block
    raises (the counterpart of tests/test_aux.py:136); its window padding
    waits only where a card is present;
  * `device_memory_stats()` is {} without a card;
  * `save_predictions` and `save_params` write the JAX writers' bytes, in
    tests/test_aux.py:60-82's cases, and refuse a changed column set with
    the JAX message.
"""

import json
import time

import numpy as np
import pytest
import torch

from multimodal_transformer_tpu.engine import csv_io as jcsv_io
from multimodal_transformer_tpu.engine import profiling as jprofiling
from multimodal_transformer_tpu_torch.engine import csv_io, profiling
from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401


def test_step_timer_summary_equals_jax():
    samples = list(np.random.RandomState(0).uniform(1e-4, 5e-2, 23))
    got, want = profiling.StepTimer("t"), jprofiling.StepTimer("t")
    assert got.summary() == want.summary() == {}
    got.samples, want.samples = list(samples), list(samples)
    assert got.summary() == want.summary()
    assert set(got.summary()) == {"n", "mean_ms", "p50_ms", "p95_ms",
                                  "total_s"}
    timer = profiling.StepTimer()
    for _ in range(3):
        with timer:
            time.sleep(0.002)
    s = timer.summary()
    assert s["n"] == 3 and s["p50_ms"] >= 2.0 and s["total_s"] >= 0.006


def _events(log_dir):
    files = [p for p in log_dir.rglob("*") if p.is_file()]
    assert len(files) == 1 and files[0].name.endswith(".pt.trace.json")
    assert files[0].stat().st_size > 0
    return json.loads(files[0].read_text())["traceEvents"]


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    a = torch.ones(64, 64)
    with profiling.trace(str(tmp_path / "ok")):
        _ = a @ a
    names = {e.get("name") for e in _events(tmp_path / "ok")}
    assert any("mm" in str(n) for n in names), sorted(map(str, names))[:20]
    with pytest.raises(RuntimeError, match="step failed"):
        with profiling.trace(str(tmp_path / "raised")):
            _ = a @ a
            raise RuntimeError("step failed")
    assert _events(tmp_path / "raised")


def test_pad_window_waits_only_with_a_card(monkeypatch):
    slept = []
    monkeypatch.setattr(profiling.time, "sleep", slept.append)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    profiling.pad_window(start=True)
    profiling.pad_window(start=False)
    assert slept == []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    profiling.pad_window(start=False)
    assert slept == [profiling.WINDOW_PAD_S] and profiling.WINDOW_PAD_S > 0


def test_device_memory_stats_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert profiling.device_memory_stats() == {}


def _files(d):
    return {p.relative_to(d): p.read_bytes() for p in sorted(d.rglob("*"))
            if p.is_file()}


def _write_all(mod, d):
    seq_ids = [("101", "2"), ("103", "5")]
    preds = [[0.1, 0.2, np.float32(0.30000001)], [0.3]]
    mod.save_predictions(seq_ids, preds, str(d / "preds"))
    ph = d / "param_hist.tsv"
    mod.save_params(str(ph), model_name="MFT",
                    args_dict={"modalities": ["a"], "batch_size": 25,
                               "split": 1, "epochs": 2, "lr": 1e-4,
                               "sup_ratio": 0.5, "base_rate": 2.0},
                    train_stats={"ccc": 0.5, "ccc_std": 0.1},
                    test_stats={"ccc": 0.4, "ccc_std": 0.2})
    mod.save_params(str(ph), model_name="SFT", args_dict={},
                    train_stats={}, test_stats={})
    mod.save_params(str(d / "extra.tsv"), model_name="B3-MFN", args_dict={},
                    train_stats={"ccc": float("nan")}, test_stats={},
                    extra={"seed": 1, "note": "a,b\tc"})
    with pytest.raises(ValueError, match="does not match") as err:
        mod.save_params(str(ph), model_name="MFT", args_dict={},
                        train_stats={}, test_stats={}, extra={"seed": 1})
    return str(err.value).replace(str(d), "<dir>")


def test_save_predictions_and_params_write_the_jax_bytes(tmp_path):
    got_err = _write_all(csv_io, tmp_path / "port")
    want_err = _write_all(jcsv_io, tmp_path / "jax")
    assert got_err == want_err
    got, want = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert got == want and len(got) == 4
    lines = (tmp_path / "port" / "param_hist.tsv").read_text().splitlines()
    assert len(lines) == 3  # header + 2 rows
    assert (tmp_path / "port" / "preds" / "target_101_2_normal.csv"
            ).read_text().splitlines()[:3] == ["rating", "0.1", "0.2"]
