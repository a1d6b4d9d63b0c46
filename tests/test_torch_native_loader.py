"""The port's binding of the native SENDv1 parser (data/native_loader.py)
against the JAX package's `native_loader`, array for array, and the reader
on it (skipped where no C++ compiler builds the library):

  * `parse_table` on every table of the synthetic fixture (tsv, csv, txt,
    ssv), NaN cells, CRLF with a trailing empty cell, and a row wider than
    its header (None from both); `window_assign` on random, unsorted and
    gapped times, and None for a time that is not finite;
  * `load_send(use_native=True)` and `window_pipeline` equal the JAX
    package's `load_send(use_native=True)` and `window_pipeline` byte for
    byte (features, float32-parsed timers, padded windows, targets);
  * the library is built in the port's `_build/` under its hashed name,
    the port never loads native/'s library, and nothing under native/
    changes; the reader logs which parser read a split, and keeps its
    Python path where the library is missing.
"""

import contextlib
import hashlib
import logging
import shutil
from pathlib import Path

import numpy as np
import pytest

from multimodal_transformer_tpu.data import native_loader as jnative
from multimodal_transformer_tpu.data import send as jsend
from multimodal_transformer_tpu.data import windowing as jwindowing
from multimodal_transformer_tpu_torch.data import load_send, window_pipeline
from multimodal_transformer_tpu_torch.data import native_loader
from multimodal_transformer_tpu_torch.data import send, windowing
from multimodal_transformer_tpu_torch.data.synthetic import \
    generate_synthetic_send
from multimodal_transformer_tpu_torch.models import default_config

MODS = ("linguistic", "emotient", "image", "acoustic")
NATIVE = Path(jnative._NATIVE_DIR)


@pytest.fixture(scope="module", autouse=True)
def _toolchain():
    """Decided here, not at import: both packages' libraries built."""
    if (shutil.which("g++") is None or not native_loader.available()
            or not jnative.available()):
        pytest.skip("no C++ toolchain for native/")


@contextlib.contextmanager
def _reader_log():
    """The reader's log lines (on "mmtx.data", whose parent the CLI's
    logger may have cut off from the root)."""
    lines = []

    class Handler(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    lg, h = logging.getLogger("mmtx.data"), Handler()
    level = lg.level
    lg.addHandler(h)
    lg.setLevel(logging.INFO)
    try:
        yield lines
    finally:
        lg.removeHandler(h)
        lg.setLevel(level)


def _snapshot(d: Path) -> dict:
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(d.iterdir()) if p.is_file()}


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("send_native")
    generate_synthetic_send(str(d), {"Train": 3, "Valid": 2}, duration_s=18.0,
                            seed=7)
    generate_synthetic_send(str(d), {"Train": 3}, duration_s=18.0, seed=7,
                            modalities=("linguistic",),
                            linguistic_variant="bert")
    return d


def _same(a, b):
    assert a is not None and b is not None
    (ga, ha), (gb, hb) = a, b
    assert ha == hb and ga.dtype == gb.dtype == np.float32
    assert ga.shape == gb.shape and ga.tobytes() == gb.tobytes()


def test_parse_table_equals_jax_on_the_fixture(data_dir):
    files = [p for p in Path(data_dir).rglob("*")
             if p.suffix in (".tsv", ".csv", ".txt", ".ssv")]
    assert {p.suffix for p in files} == {".tsv", ".csv", ".txt", ".ssv"}
    for p in files:
        fmt = p.suffix[1:]
        _same(native_loader.parse_table(str(p), fmt),
              jnative.parse_table(str(p), fmt))


@pytest.mark.parametrize("name,body", [
    ("nan.csv", b"a,b\n1.5,nan\n2.5,x\n,3.5\n"),
    ("crlf.csv", b"a,b,c\r\n1,2,\r\n3,4,5\r\n"),
    ("ragged.tsv", b"t\tx0\tx1\n0.5\t\t2.25\n1.0\n\n2.0\tNaN\tnull\n"),
    ("ws.ssv", b"Frametime  v0 v1\n 0.1   2 3\n0.2\t4 5\n")])
def test_parse_table_edge_cases_equal_jax(tmp_path, name, body):
    p = tmp_path / name
    p.write_bytes(body)
    fmt = name.split(".")[1]
    got = native_loader.parse_table(str(p), fmt)
    _same(got, jnative.parse_table(str(p), fmt))
    if name == "crlf.csv":
        assert got[1] == ["a", "b", "c"] and np.isnan(got[0][0, 2])
        assert got[0][1].tolist() == [3.0, 4.0, 5.0]
    if name == "nan.csv":
        assert np.isnan(got[0][[0, 1, 2], [1, 1, 0]]).all()


def test_row_wider_than_header_gives_none(tmp_path):
    for name, text in (("t.csv", "a,b\n1,2,9\n"), ("t.ssv", "a b\n1 2 9\n")):
        p = tmp_path / name
        p.write_text(text)
        fmt = name.split(".")[1]
        assert native_loader.parse_table(str(p), fmt) is None
        assert jnative.parse_table(str(p), fmt) is None


def test_window_assign_equals_jax():
    rs = np.random.RandomState(3)
    times = np.sort(rs.uniform(0, 30, 60))
    times[20:26] = times[20:26][::-1]  # out of order
    times = np.concatenate([times[:30], times[30:] + 7.3])  # a gap
    for t in (times, np.cumsum(rs.rand(200) * 0.7), times[:0], times[:1]):
        for ws in (1, 5, 0.3, 2.5):
            got = native_loader.window_assign(t, ws)
            want = jnative.window_assign(t, ws)
            assert len(got) == len(want) == 2
            for g, w in zip(got, want):
                assert g.dtype == w.dtype == np.int64
                assert np.array_equal(g, w)
    # the native loop never ends on a NaN or infinite time: refused, and
    # the windowing takes its Python path, which raises
    for bad in (np.nan, np.inf):
        t = times.copy()
        t[7] = bad
        assert native_loader.window_assign(t, 1.0) is None
        with pytest.raises(ValueError, match="finite"):
            windowing.window_channel(np.zeros((len(t), 2), np.float32), t,
                                     1.0, 1)


@pytest.mark.parametrize("variant", ["glove", "bert"])
def test_load_send_and_window_pipeline_equal_jax_native(data_dir, variant):
    with _reader_log() as lines:
        got = load_send(MODS, str(data_dir), "Train",
                        linguistic_variant=variant, use_native=True)
    assert len(lines) == 1
    assert "Train: 15 of 15 files read by the native parser" in lines[0]
    want = jsend.load_send(MODS, str(data_dir), "Train",
                           linguistic_variant=variant, use_native=True)
    assert got.seq_ids == want.seq_ids and got.lengths == want.lengths
    for m in want.modalities:
        for g, w in zip(got.data[m], want.data[m], strict=True):
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), m
        for g, w in zip(got.timers[m], want.timers[m], strict=True):
            assert g.dtype == w.dtype == np.float64
            assert g.tobytes() == w.tobytes(), m
    # the native timers are float32 values, unlike the Python path's
    python = load_send(MODS, str(data_dir), "Train",
                       linguistic_variant=variant, use_native=False)
    assert any(not np.array_equal(g, p) for g, p in
               zip(got.timers["linguistic"], python.timers["linguistic"]))
    for family, mods in (("MFT", ("acoustic", "image", "linguistic")),
                         ("SFT", ("emotient", "linguistic"))):
        cfg = default_config(family, mods)
        dims = dict(cfg.mod_dimension)
        if variant == "bert":
            dims["linguistic"] = 1024
        g = window_pipeline(got, cfg.window_size, mods, dims)
        w = jwindowing.window_pipeline(want, cfg.window_size, mods, dims)
        assert g[2] == w[2] and g[1].tobytes() == w[1].tobytes()
        for m in mods:
            assert g[0][m].tobytes() == w[0][m].tobytes(), m


def test_library_lands_in_the_port_build_dir(data_dir):
    before = _snapshot(NATIVE)
    lib = native_loader.build()
    assert lib == native_loader.library_path()
    assert lib.parent == native_loader.BUILD_DIR
    assert lib.parent.name == "_build" and lib.name.startswith("libfastload_")
    assert native_loader._lib._name == str(lib)
    assert NATIVE not in lib.parents
    load_send(MODS, str(data_dir), "Valid")
    assert _snapshot(NATIVE) == before


def test_reader_keeps_the_python_path_without_the_library(data_dir,
                                                          monkeypatch):
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "_tried", True)
    monkeypatch.setattr(native_loader, "build_error", "no compiler")
    assert not native_loader.available()
    with _reader_log() as lines:
        got = send.load_send(MODS, str(data_dir), "Valid")
    assert "0 of 10 files read by the native parser" in lines[0]
    assert "no compiler" in lines[0]
    want = send.load_send(MODS, str(data_dir), "Valid", use_native=False)
    for m in want.modalities:
        for g, w in zip(got.timers[m], want.timers[m], strict=True):
            assert g.tobytes() == w.tobytes()
