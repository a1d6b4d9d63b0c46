"""The port's pandas-free SENDv1 reader, windowing, collate helpers and
prefetcher against the JAX package, on the CLI tests' synthetic fixture
(3/2/2 videos of 13.5-22.5 s, seed 7; tests/test_cli.py):

  * the port's generator writes the JAX generator's bytes (both linguistic
    variants);
  * `load_send(use_native=False)` (the port's Python path) equals the JAX
    `load_send(use_native=False)` (the pandas path) exactly: features, timers, lengths, IDs, for every modality and
    both linguistic variants, also after `normalize` and `split`;
  * the JAX native parser differs from it only in the timers, which it
    parses to float32 (each native timer is the port's rounded to float32);
  * `window_pipeline` equals the JAX `window_pipeline` exactly, with the
    JAX package's while loop (native assignment off in both packages) and
    with both native assignments; `window_channel` / `window_ratings` equal the loop on
    unsorted times with gaps and fractional window sizes, and an empty
    rating window raises the loop's message;
  * `len_to_mask`, `pad_and_merge`, `seq_collate_dict` equal the JAX ones;
  * `DevicePrefetcher` on the CPU yields the same batches in the same order
    as the iterator, and a worker's exception reaches the consumer.
"""

import filecmp

import numpy as np
import pytest
import torch

from multimodal_transformer_tpu.data import batching as jbatching
from multimodal_transformer_tpu.data import native_loader
from multimodal_transformer_tpu.data import send as jsend
from multimodal_transformer_tpu.data import synthetic as jsynthetic
from multimodal_transformer_tpu.data import windowing as jwindowing
from multimodal_transformer_tpu_torch.data import (batching, load_send,
                                                   window_pipeline)
from multimodal_transformer_tpu_torch.data import native_loader as pnative
from multimodal_transformer_tpu_torch.data import windowing
from multimodal_transformer_tpu_torch.data.prefetch import DevicePrefetcher
from multimodal_transformer_tpu_torch.data.send import read_table
from multimodal_transformer_tpu_torch.data.synthetic import \
    generate_synthetic_send
from multimodal_transformer_tpu_torch.models import default_config

SUBSETS = {"Train": 3, "Valid": 2, "Test": 2}
MODS = ("linguistic", "emotient", "image", "acoustic")


def _generate(fn, d):
    fn(str(d), SUBSETS, duration_s=18.0, seed=7)
    fn(str(d), SUBSETS, duration_s=18.0, seed=7, modalities=("linguistic",),
       linguistic_variant="bert")


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("send")
    _generate(generate_synthetic_send, d)
    return d


def _same_tree(cmp):
    assert not (cmp.left_only or cmp.right_only or cmp.diff_files), (
        cmp.left_only, cmp.right_only, cmp.diff_files)
    for sub in cmp.subdirs.values():
        _same_tree(sub)


def test_generator_writes_the_jax_bytes(data_dir, tmp_path):
    _generate(jsynthetic.generate_synthetic_send, tmp_path)
    cmp = filecmp.dircmp(str(data_dir), str(tmp_path))
    _same_tree(cmp)
    filecmp.clear_cache()
    assert cmp.common_dirs == ["features", "ratings"]


def _assert_same(got, want):
    assert got.modalities == want.modalities
    assert got.seq_ids == want.seq_ids and got.lengths == want.lengths
    for m in want.modalities:
        for g, w in zip(got.data[m], want.data[m], strict=True):
            assert g.dtype == w.dtype
            assert np.array_equal(g, w, equal_nan=True), m
    for m in want.timers:
        for g, w in zip(got.timers[m], want.timers[m], strict=True):
            assert g.dtype == w.dtype == np.float64
            assert np.array_equal(g, w), m


@pytest.mark.parametrize("variant", ["glove", "bert"])
@pytest.mark.parametrize("subset", ["Train", "Valid"])
def test_load_send_equals_the_pandas_path(data_dir, subset, variant):
    got = load_send(MODS, str(data_dir), subset, linguistic_variant=variant,
                    use_native=False)
    want = jsend.load_send(MODS, str(data_dir), subset,
                           linguistic_variant=variant, use_native=False)
    _assert_same(got, want)
    assert np.isnan(np.concatenate(got.data["emotient"])).any()
    _assert_same(got.normalize(), want.normalize())
    _assert_same(got.split(2), want.split(2))
    merged = type(got).merge(got, got)
    assert merged.seq_ids == got.seq_ids * 2


def test_native_parser_differs_only_in_float32_timers(data_dir):
    """What the JAX native parser (`use_native=True`) gives on the fixture:
    the same features, and timers parsed to float32 and widened."""
    got = load_send(MODS, str(data_dir), "Train", use_native=False)
    if native_loader.available():
        native = jsend.load_send(MODS, str(data_dir), "Train",
                                 use_native=True)
    else:  # what it would give: the fields parsed to float32
        native = jsend.load_send(MODS, str(data_dir), "Train",
                                 use_native=False)
        native.timers = {m: [t.astype(np.float32).astype(np.float64)
                             for t in v] for m, v in native.timers.items()}
    differ = set()
    for m in MODS + ("ratings",):
        for g, n in zip(got.data[m], native.data[m], strict=True):
            assert np.array_equal(g, n, equal_nan=True), m
        for g, n in zip(got.timers[m], native.timers[m], strict=True):
            assert np.array_equal(g.astype(np.float32).astype(np.float64), n)
            if not np.array_equal(g, n):
                differ.add(m)
    # the 0.5-s steps of acoustic and ratings are exact in float32
    assert differ == {"linguistic", "emotient", "image"}


@pytest.mark.parametrize("fmt,text", [
    ("csv", "a, b,c\n1,2,3\n\n4,,NA\n5\n-1e-3,nan,\"7\"\n"),
    ("tsv", "t\tx0\tx1\n0.5\t\t2.25\n1.0\tNaN\tnull\n"),
    ("ssv", "Frametime  v0 v1\n 0.1   2 3\n0.2\t4 5\n")])
def test_read_table_equals_pandas(tmp_path, fmt, text):
    p = tmp_path / f"t.{fmt}"
    p.write_text(text)
    header, table = read_table(str(p), fmt)
    df = jsend._read_table(str(p), fmt)
    assert header == list(df.columns)
    assert np.array_equal(table, np.asarray(df, dtype=np.float64),
                          equal_nan=True)
    p.write_text("a,b\n1,2,3\n")
    with pytest.raises(ValueError, match="3 fields"):
        read_table(str(p), "csv")


@pytest.mark.parametrize("family,mods,native", [
    ("MFT", ("acoustic", "image", "linguistic"), False),
    ("MFT", ("acoustic", "image", "linguistic"), True),
    ("SFT", ("emotient", "linguistic"), False),
    ("B1-LSTM", ("acoustic", "linguistic"), False)])
def test_window_pipeline_equals_jax(data_dir, monkeypatch, family, mods,
                                    native):
    cfg = default_config(family, mods)
    ws = dict(cfg.window_size)
    if family == "B1-LSTM":  # the CLI's lift to the 5-s rating windows
        ws.update({m: ws["ratings"] for m in mods if ws[m] < ws["ratings"]})
    variant = "bert" if family == "B1-LSTM" else "glove"
    if not native:
        monkeypatch.setattr(native_loader, "window_assign",
                            lambda *a: None)
        monkeypatch.setattr(pnative, "window_assign", lambda *a: None)
    ds = load_send(mods, str(data_dir), "Train", linguistic_variant=variant,
                   use_native=False)
    jds = jsend.load_send(mods, str(data_dir), "Train",
                          linguistic_variant=variant, use_native=False)
    got = window_pipeline(ds, ws, mods, cfg.mod_dimension)
    want = jwindowing.window_pipeline(jds, ws, mods, cfg.mod_dimension)
    assert got[2] == want[2]
    assert np.array_equal(got[1], want[1])
    for m in mods:
        assert got[0][m].dtype == np.float32
        assert np.array_equal(got[0][m], want[0][m]), m


def test_window_assignment_equals_the_loop(monkeypatch):
    monkeypatch.setattr(native_loader, "window_assign", lambda *a: None)
    monkeypatch.setattr(pnative, "window_assign", lambda *a: None)
    rs = np.random.RandomState(3)
    feats = rs.randn(60, 4).astype(np.float32)
    feats[5, 1] = np.nan
    times = np.sort(rs.uniform(0, 30, 60))
    times[20:26] = times[20:26][::-1]  # out of order
    times = np.concatenate([times[:30], times[30:] + 7.3])  # a gap
    for ws, over in ((1, 1), (5, 5), (0.3, 2), (2.5, 1)):
        got = windowing.window_channel(feats, times, ws, over)
        want = jwindowing.window_channel(feats, times, ws, over)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert np.array_equal(g, w)
    assert windowing.window_channel(feats[:0], times[:0], 1, 1) == []
    ratings = rs.rand(60) * 100
    dense = np.arange(60) * 0.5 + rs.uniform(0, 0.05, 60)
    for ws in (0.7, 1.0, 2.5):
        assert (windowing.window_ratings(ratings, dense, ws)
                == jwindowing.window_ratings(ratings, dense, ws))
    for ws in (1, 0.3):
        with pytest.raises(ValueError) as want:
            jwindowing.window_ratings(ratings, times, ws)
        with pytest.raises(ValueError) as got:
            windowing.window_ratings(ratings, times, ws)
        assert str(got.value) == str(want.value)


def test_collate_helpers_equal_jax():
    rs = np.random.RandomState(0)
    items = [{"a": rs.randn(n, 3), "b": rs.randn(n, 2), "length": n}
             for n in (4, 7, 2, 7)]
    got, gmask, glens = batching.seq_collate_dict(items)
    want, wmask, wlens = jbatching.seq_collate_dict(items)
    assert glens == wlens and np.array_equal(gmask, wmask)
    for m in ("a", "b"):
        assert np.array_equal(got[m], want[m])
    seqs = [x["a"] for x in items]
    assert np.array_equal(batching.pad_and_merge(seqs, 5),
                          jbatching.pad_and_merge([s[:5] for s in seqs], 5))
    assert np.array_equal(batching.len_to_mask([3, 1, 0]),
                          jbatching.len_to_mask([3, 1, 0]))


def test_prefetcher_keeps_batches_and_raises_worker_errors():
    rs = np.random.RandomState(1)
    data = {"a": rs.randn(7, 9, 2, 3).astype(np.float32)}
    target = rs.randn(7, 9).astype(np.float32)
    lens = [9, 3, 5, 8, 1, 7, 6]
    want = list(batching.make_batches(data, target, lens, 2, True,
                                      np.random.RandomState(4)))
    got = list(DevicePrefetcher(batching.make_batches(
        data, target, lens, 2, True, np.random.RandomState(4)), "cpu",
        depth=2))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.lengths == w.lengths and g.indices == w.indices
        assert isinstance(g.mask, torch.Tensor) and g.mask.is_contiguous()
        assert torch.equal(g.data["a"], torch.from_numpy(w.data["a"]))
        assert torch.equal(g.target, torch.from_numpy(w.target))
        assert torch.equal(g.mask, torch.from_numpy(w.mask))

    def failing():
        yield want[0]
        raise RuntimeError("reader failed")

    seen = []
    with pytest.raises(RuntimeError, match="reader failed"):
        for b in DevicePrefetcher(failing(), "cpu"):
            seen.append(b)
    assert len(seen) == 1
    # leaving early stops the worker
    pf = DevicePrefetcher(iter(want * 50), "cpu", depth=1)
    next(iter(pf))
    pf.close()
    assert not pf._thread.is_alive()
