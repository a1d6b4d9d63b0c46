"""`python -m multimodal_transformer_tpu_torch.walkthrough --device cpu
--epochs 1` (the counterpart of examples/walkthrough.py) on the CPU: its
five steps run and leave a `.pth` checkpoint, PerfSave with one row per
Test video, a PredSave trace, and a served trace per Test video; without
a card and without --device cpu it refuses to run."""

import csv

import numpy as np
import pytest
import torch

from multimodal_transformer_tpu_torch import walkthrough
from multimodal_transformer_tpu_torch.data import load_send
from multimodal_transformer_tpu_torch.engine import seq_id_strings
from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def test_walkthrough_on_the_cpu(tmp_path, capsys):
    out = walkthrough.main(["--workdir", str(tmp_path), "--epochs", "1",
                            "--device", "cpu"])
    printed = capsys.readouterr().out
    for step in range(1, 6):
        assert f"[{step}/5]" in printed
    assert out["checkpoint"].endswith("ModelSave/B3-MFN/B3-MFN-AL.pth")
    assert (tmp_path / "ModelSave" / "B3-MFN" / "B3-MFN-AL.pth").is_file()
    assert np.isfinite(out["test_stats"]["ccc"])

    test = load_send(("acoustic", "linguistic"),
                     str(tmp_path / "SENDv1-data"), "Test")
    ids = seq_id_strings(test.seq_ids)
    assert len(ids) == 3
    perf = _rows(tmp_path / "PerfSave" / "B3-MFN.csv")
    assert perf[0] == ["Model", "Combination", "VidID", "Set", "CCC"]
    assert [r[:4] for r in perf[1:]] == [["B3-MFN", "AL", i, "Test"]
                                         for i in ids]
    assert all(np.isfinite(float(r[4])) for r in perf[1:])
    pred = _rows(tmp_path / "PredSave" / f"B3-MFN{ids[0]}.csv")
    assert pred[0] == ["time", "pred", "actual"] and len(pred) > 2
    assert [int(r[0]) for r in pred[1:]] == list(range(len(pred) - 1))

    traces = out["traces"]
    assert sorted(traces) == sorted(ids)
    for t in traces.values():
        assert t.dtype == np.float32 and len(t) > 0 and np.isfinite(t).all()
    assert len(traces[ids[0]]) == len(pred) - 1


def test_walkthrough_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit) as e:
        walkthrough.main(["--workdir", str(tmp_path), "--epochs", "1"])
    assert "no CUDA device" in str(e.value.code)
    assert not any(tmp_path.iterdir())
