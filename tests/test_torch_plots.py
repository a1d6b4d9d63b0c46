"""The port's plots (engine/plots.py) without matplotlib: the PNG decodes
(signature, IHDR size, CRCs, inflated filter-0 rows) to matplotlib's figure
sizes at 100 dots an inch; each curve of a known trace lies at the pixels
its data maps to (`Panel.to_px`), within 1 px; the panels, colours, titles
and labels are those of the JAX package's `plot_predictions` and
`plot_eval`."""

import struct
import zlib

import numpy as np
import pytest

from multimodal_transformer_tpu_torch.engine import plots
from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401


def decode_png(path) -> np.ndarray:
    """An 8-bit RGB PNG of filter-0 rows as [H, W, 3] uint8; asserts the
    signature, the chunk CRCs and the IHDR fields."""
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, []
    while pos < len(data):
        n, = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        crc, = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(kind + body) & 0xFFFFFFFF, kind
        chunks.append((kind, body))
        pos += 12 + n
    assert chunks[0][0] == b"IHDR" and chunks[-1][0] == b"IEND"
    w, h, depth, ctype, comp, filt, lace = struct.unpack(">IIBBBBB",
                                                         chunks[0][1])
    assert (depth, ctype, comp, filt, lace) == (8, 2, 0, 0, 0)
    raw = zlib.decompress(b"".join(b for k, b in chunks if k == b"IDAT"))
    rows = np.frombuffer(raw, np.uint8).reshape(h, 1 + 3 * w)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(h, w, 3)


def _near(img, x, y, color, r: int = 1) -> bool:
    """Whether a pixel within r of (x, y) has the colour."""
    xi, yi = int(round(x)), int(round(y))
    patch = img[yi - r:yi + r + 1, xi - r:xi + r + 1]
    return bool((patch == np.array(color, np.uint8)).all(-1).any())


def _has_text(img, box, text: str, scale: int, band) -> bool:
    """Whether text's bitmap appears, black, in the rows band (relative to
    the box's top) over the box's columns."""
    left, top, right, _ = box
    region = img[top + band[0]:top + band[1], max(left - 60, 0):right + 60]
    dark = (region == 0).all(-1)
    bm = plots.text_bitmap(text, scale)
    win = np.lib.stride_tricks.sliding_window_view(dark, bm.shape)
    return bool(win[..., bm].all(-1).any())


def _traces(n_videos: int):
    """Videos of different lengths: truth a sine in [-0.8, 0.8], the
    prediction its negative halved, so that the two curves cross only
    where the sine is near 0."""
    acts = [0.8 * np.sin(np.linspace(0, 5, 30 + 11 * i))
            for i in range(n_videos)]
    return acts, [-0.5 * a for a in acts]


def _assert_curve(img, panel, x, y, color, other):
    """Every point of the curve lies on its colour, where the other curve
    is more than 4 px away."""
    px, py = panel.to_px(x, y)
    ox, oy = panel.to_px(x, other)
    checked = 0
    for a, b, c in zip(px, py, oy):
        if abs(b - c) > 4:
            assert _near(img, a, b, color), (a, b, color)
            checked += 1
    assert checked > len(px) // 2


def test_plot_predictions_png(tmp_path):
    acts, preds = _traces(9)
    metric = [0.1 * i - 0.3 for i in range(9)]
    path = tmp_path / "fits.png"
    panels = plots.plot_predictions(acts, preds, metric, str(path))
    img = decode_png(path)
    assert img.shape == (1000, 800, 3)
    # top-4 by metric, best first, then the bottom 4
    order = [8, 7, 6, 5, 0, 1, 2, 3]
    assert len(panels) == 8
    for n, (idx, panel) in enumerate(zip(order, panels)):
        j, i = divmod(n, 4)  # column j, row i of the 4 x 2 grid
        left, top, right, bottom = panel.box
        assert (left < 400) == (j == 0) and top // 250 == i
        assert panel.xlim == (0.0, len(acts[idx])) and panel.ylim == (-1, 1)
        t = np.arange(len(acts[idx]))
        _assert_curve(img, panel, t, acts[idx], plots.BLUE, preds[idx])
        _assert_curve(img, panel, t, preds[idx], plots.CYAN, acts[idx])
        assert _has_text(img, panel.box, "Fit = {:0.3f}".format(metric[idx]),
                         2, (-30, 0))


def test_plot_eval_png(tmp_path):
    acts, preds = _traces(12)

    def to01(v):  # plot_eval maps [0, 1] onto [-1, 1]
        return [x / 2 + 0.5 for x in v]

    cccs = [0.9 - 0.05 * i for i in range(12)]
    ids = [f"{100 + i}_{i % 3 + 1}" for i in range(12)]
    path = tmp_path / "eval.png"
    panels = plots.plot_eval([to01(p) for p in preds], cccs,
                             [to01(a) for a in acts], ids, str(path),
                             window_size=5)
    img = decode_png(path)
    assert img.shape == (700, 1800, 3)
    assert len(panels) == 10  # min(10, videos)
    for i, panel in enumerate(panels):
        left, top, _, _ = panel.box
        assert left // 360 == i % 5 and top // 350 == i // 5
        t = 5.0 * np.arange(len(acts[i]))
        x0, x1 = panel.xlim
        assert x0 < 0 < t[-1] < x1  # the data's range with margins
        _assert_curve(img, panel, t, preds[i], plots.RED, acts[i])
        _assert_curve(img, panel, t, acts[i], plots.BLUE, preds[i])
        assert _has_text(img, panel.box,
                         "ccc=" + str(cccs[i])[:5] + "-vid=" + ids[i], 2,
                         (-30, 0))
        assert _has_text(img, panel.box, "time(s)", 2, (300 - 60, 300))


@pytest.mark.parametrize("lengths", [(1, 2), (0, 3)])
def test_short_traces_plot(tmp_path, lengths):
    """One-window and empty videos plot without error (a lone point, an
    empty panel)."""
    acts = [np.zeros(n) for n in lengths]
    path = tmp_path / "short.png"
    plots.plot_eval(acts, [0.0, 0.0], acts, ["1_1", "2_1"], str(path))
    plots.plot_predictions(acts * 4, acts * 4, [0.0] * 8, str(path))
    assert decode_png(path).shape == (1000, 800, 3)
