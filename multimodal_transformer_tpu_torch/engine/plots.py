"""Prediction plots without matplotlib: the top/bottom-4 fit grid and the
10-panel prediction-vs-truth figure, written as 8-bit RGB PNGs.

Counterpart of `multimodal_transformer_tpu/engine/plots.py` (reference
MFT/train.py:259-315), with its signatures, panels, colours, y-range
[-1, 1], titles and axis labels.  The figures are rasterised here with
numpy and a 5 x 7 bitmap font and encoded with `zlib` and `struct`; they
are not matplotlib's pixels, but every curve lands at the pixels its data
maps to: x from the panel's x-range and y from [-1, 1] onto the panel's
axes box (`Panel.to_px`).  Each function returns its panels, so that a
reader can map data to pixels.  Sizes are matplotlib's figure sizes at 100
dots an inch: 800 x 1,000 (fits) and 1,800 x 700 (eval).
"""

from __future__ import annotations

import dataclasses
import struct
import zlib
from typing import Sequence

import numpy as np

WHITE, BLACK, GREY = (255, 255, 255), (0, 0, 0), (176, 176, 176)
# matplotlib's "b", "c", "r" and "blue"
BLUE, CYAN, RED = (0, 0, 255), (0, 191, 191), (255, 0, 0)
DPI = 100

_GLYPHS = {  # 5 x 7, rows top to bottom
    '0': ".###.|#...#|#..##|#.#.#|##..#|#...#|.###.",
    '1': "..#..|.##..|..#..|..#..|..#..|..#..|.###.",
    '2': ".###.|#...#|....#|...#.|..#..|.#...|#####",
    '3': "#####|...#.|..#..|...#.|....#|#...#|.###.",
    '4': "...#.|..##.|.#.#.|#..#.|#####|...#.|...#.",
    '5': "#####|#....|####.|....#|....#|#...#|.###.",
    '6': "..##.|.#...|#....|####.|#...#|#...#|.###.",
    '7': "#####|....#|...#.|..#..|.#...|.#...|.#...",
    '8': ".###.|#...#|#...#|.###.|#...#|#...#|.###.",
    '9': ".###.|#...#|#...#|.####|....#|...#.|.##..",
    '.': ".....|.....|.....|.....|.....|.##..|.##..",
    '-': ".....|.....|.....|#####|.....|.....|.....",
    '=': ".....|.....|#####|.....|#####|.....|.....",
    '_': ".....|.....|.....|.....|.....|.....|#####",
    '(': "...#.|..#..|.#...|.#...|.#...|..#..|...#.",
    ')': ".#...|..#..|...#.|...#.|...#.|..#..|.#...",
    ' ': ".....|.....|.....|.....|.....|.....|.....",
    'a': ".....|.....|.###.|....#|.####|#...#|.####",
    'b': "#....|#....|#.##.|##..#|#...#|#...#|####.",
    'c': ".....|.....|.###.|#....|#....|#...#|.###.",
    'd': "....#|....#|.##.#|#..##|#...#|#...#|.####",
    'e': ".....|.....|.###.|#...#|#####|#....|.###.",
    'f': "..##.|.#..#|.#...|###..|.#...|.#...|.#...",
    'g': ".....|.####|#...#|#...#|.####|....#|.###.",
    'h': "#....|#....|#.##.|##..#|#...#|#...#|#...#",
    'i': "..#..|.....|.##..|..#..|..#..|..#..|.###.",
    'j': "...#.|.....|..##.|...#.|...#.|#..#.|.##..",
    'k': "#....|#....|#..#.|#.#..|##...|#.#..|#..#.",
    'l': ".##..|..#..|..#..|..#..|..#..|..#..|.###.",
    'm': ".....|.....|##.#.|#.#.#|#.#.#|#...#|#...#",
    'n': ".....|.....|#.##.|##..#|#...#|#...#|#...#",
    'o': ".....|.....|.###.|#...#|#...#|#...#|.###.",
    'p': ".....|.....|####.|#...#|####.|#....|#....",
    'q': ".....|.....|.##.#|#..##|.####|....#|....#",
    'r': ".....|.....|#.##.|##..#|#....|#....|#....",
    's': ".....|.....|.###.|#....|.###.|....#|####.",
    't': ".#...|.#...|###..|.#...|.#...|.#..#|..##.",
    'u': ".....|.....|#...#|#...#|#...#|#..##|.##.#",
    'v': ".....|.....|#...#|#...#|#...#|.#.#.|..#..",
    'w': ".....|.....|#...#|#...#|#.#.#|#.#.#|.#.#.",
    'x': ".....|.....|#...#|.#.#.|..#..|.#.#.|#...#",
    'y': ".....|.....|#...#|#...#|.####|....#|.###.",
    'z': ".....|.....|#####|...#.|..#..|.#...|#####",
    'F': "#####|#....|#....|####.|#....|#....|#....",
    'P': "####.|#...#|#...#|####.|#....|#....|#....",
    'T': "#####|..#..|..#..|..#..|..#..|..#..|..#..",
}


def _glyph(ch: str) -> np.ndarray:
    """A [7, 5] bool bitmap; unknown characters are an outlined box."""
    rows = _GLYPHS.get(ch) or _GLYPHS.get(ch.lower())
    if rows is None:
        box = np.ones((7, 5), bool)
        box[1:-1, 1:-1] = False
        return box
    return np.array([[c == "#" for c in r] for r in rows.split("|")], bool)


def text_bitmap(s: str, scale: int = 1) -> np.ndarray:
    """s rendered left to right, one blank column between glyphs."""
    cols = []
    for ch in s:
        cols += [_glyph(ch), np.zeros((7, 1), bool)]
    bm = np.concatenate(cols, axis=1) if cols else np.zeros((7, 0), bool)
    return np.kron(bm, np.ones((scale, scale), bool))


class Canvas:
    """An RGB image, white to start with."""

    def __init__(self, width: int, height: int):
        self.img = np.full((height, width, 3), 255, np.uint8)

    def fill(self, x0, y0, x1, y1, color) -> None:
        h, w = self.img.shape[:2]
        self.img[max(y0, 0):min(y1, h), max(x0, 0):min(x1, w)] = color

    def bitmap(self, bm: np.ndarray, x: int, y: int, color) -> None:
        """bm's set pixels at top-left (x, y), clipped to the image."""
        h, w = self.img.shape[:2]
        ys, xs = np.nonzero(bm)
        ys, xs = ys + y, xs + x
        keep = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
        self.img[ys[keep], xs[keep]] = color

    def text(self, s: str, x: int, y: int, color=BLACK, scale: int = 1,
             anchor: str = "left", vertical: bool = False) -> None:
        """anchor: "left", "center" or "right" of the text's run at x; y is
        the top (the left edge for vertical text, which reads upwards)."""
        bm = text_bitmap(s, scale)
        if vertical:
            bm = np.rot90(bm)
        run = bm.shape[0] if vertical else bm.shape[1]
        off = {"left": 0, "center": run // 2, "right": run}[anchor]
        if vertical:
            self.bitmap(bm, x, y - off, color)
        else:
            self.bitmap(bm, x - off, y, color)

    def polyline(self, xs, ys, color, width: int, clip) -> None:
        """Straight segments through the pixel points (xs, ys), `width`
        pixels wide, clipped to clip = (x0, y0, x1, y1)."""
        xs, ys = np.asarray(xs, float), np.asarray(ys, float)
        if xs.size == 1:
            px, py = xs, ys
        else:
            dx, dy = np.diff(xs), np.diff(ys)
            n = np.ceil(np.maximum(np.abs(dx), np.abs(dy)) * 2).astype(int) + 1
            seg = np.repeat(np.arange(dx.size), n)
            t = (np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n)) / \
                np.repeat(n - 1, n)
            px = xs[:-1][seg] + t * dx[seg]
            py = ys[:-1][seg] + t * dy[seg]
        px, py = np.rint(px).astype(int), np.rint(py).astype(int)
        x0, y0, x1, y1 = clip
        for oy in range(-(width // 2), width - width // 2):
            for ox in range(-(width // 2), width - width // 2):
                qx, qy = px + ox, py + oy
                keep = (qx >= x0) & (qx <= x1) & (qy >= y0) & (qy <= y1)
                self.img[qy[keep], qx[keep]] = color


def write_png(path: str, rgb: np.ndarray) -> None:
    """An 8-bit RGB PNG of rgb [H, W, 3] uint8: IHDR, one zlib IDAT of
    filter-0 rows, IEND."""
    h, w, _ = rgb.shape

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           rgb.reshape(h, w * 3)], axis=1)
    png = (b"\x89PNG\r\n\x1a\n"
           + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
           + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)


def read_png(path: str) -> np.ndarray:
    """The [H, W, 3] uint8 pixels of a PNG that `write_png` wrote; raises
    ValueError on a wrong signature, chunk CRC, header or row filter."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos, chunks = 8, {}
    while pos + 12 <= len(data):
        n, = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        crc, = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if crc != zlib.crc32(kind + body) & 0xFFFFFFFF:
            raise ValueError(f"{path}: bad CRC in {kind!r}")
        chunks[kind] = chunks.get(kind, b"") + body
        pos += 12 + n
    w, h, depth, ctype, _, _, lace = struct.unpack(">IIBBBBB",
                                                   chunks[b"IHDR"])
    if (depth, ctype, lace) != (8, 2, 0) or b"IEND" not in chunks:
        raise ValueError(f"{path}: not an 8-bit RGB PNG")
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    rows = rows.reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise ValueError(f"{path}: filtered rows")
    return rows[:, 1:].reshape(h, w, 3)


@dataclasses.dataclass(frozen=True)
class Panel:
    """One axes box: pixel corners (left, top, right, bottom) and its data
    limits."""
    box: tuple
    xlim: tuple
    ylim: tuple = (-1.0, 1.0)

    def to_px(self, x, y):
        """Data (x, y) -> pixel (column, row), floats."""
        left, top, right, bottom = self.box
        (x0, x1), (y0, y1) = self.xlim, self.ylim
        sx = (right - left) / ((x1 - x0) or 1.0)
        sy = (bottom - top) / ((y1 - y0) or 1.0)
        return (left + (np.asarray(x, float) - x0) * sx,
                bottom - (np.asarray(y, float) - y0) * sy)


def _axes(cv: Canvas, panel: Panel, title: str, xticks, xlabel: str = "",
          ylabel: str = "", title_scale: int = 2) -> None:
    """Frame, y ticks every 0.5, the given x ticks, tick labels, title and
    axis labels."""
    left, top, right, bottom = panel.box
    for v in (-1.0, -0.5, 0.0, 0.5, 1.0):
        _, ty = panel.to_px(panel.xlim[0], v)
        ty = int(round(float(ty)))
        cv.fill(left - 4, ty, left, ty + 1, BLACK)
        cv.text(f"{v:.1f}", left - 6, ty - 3, anchor="right")
    for v in xticks:
        tx, _ = panel.to_px(v, panel.ylim[0])
        tx = int(round(float(tx)))
        cv.fill(tx, bottom, tx + 1, bottom + 4, BLACK)
        cv.text(f"{v:g}", tx, bottom + 6, anchor="center")
    cv.fill(left, top, right + 1, top + 1, BLACK)
    cv.fill(left, bottom, right + 1, bottom + 1, BLACK)
    cv.fill(left, top, left + 1, bottom + 1, BLACK)
    cv.fill(right, top, right + 1, bottom + 1, BLACK)
    cv.text(title, (left + right) // 2, top - 7 * title_scale - 6,
            scale=title_scale, anchor="center")
    if xlabel:
        cv.text(xlabel, (left + right) // 2, bottom + 18, anchor="center",
                scale=2)
    if ylabel:
        cv.text(ylabel, left - 48, (top + bottom) // 2, anchor="center",
                scale=2, vertical=True)


def _curve(cv: Canvas, panel: Panel, x, y, color, width: int) -> None:
    if len(y) == 0:
        return
    px, py = panel.to_px(x, y)
    left, top, right, bottom = panel.box
    cv.polyline(px, py, color, width, (left + 1, top + 1, right - 1,
                                       bottom - 1))


def _grid(width: int, height: int, rows: int, cols: int, margins) -> list:
    """Axes boxes of a rows x cols grid, row-major; margins (left, top,
    right, bottom) inside each cell."""
    cw, ch = width // cols, height // rows
    ml, mt, mr, mb = margins
    return [(c * cw + ml, r * ch + mt, (c + 1) * cw - mr, (r + 1) * ch - mb)
            for r in range(rows) for c in range(cols)]


def plot_predictions(actuals: Sequence[Sequence[float]],
                     predictions: Sequence[Sequence[float]],
                     metric: Sequence[float], fig_path: str) -> list:
    """Top-4 and bottom-4 fits by metric, 4 x 2 grid (reference
    plot_predictions, train.py:259-279): truth in blue, prediction in cyan,
    x over [0, len(true)], y over [-1, 1], titled "Fit = 0.123".  Returns
    the panels, in the order of the selected videos."""
    sel_idx = np.concatenate((np.argsort(metric)[-4:][::-1],
                              np.argsort(metric)[:4]))
    cv = Canvas(8 * DPI, 10 * DPI)
    boxes = _grid(8 * DPI, 10 * DPI, 4, 2, (50, 34, 14, 26))
    panels = []
    for n, idx in enumerate(sel_idx):
        j, i = divmod(n, 4)
        true = np.asarray(actuals[idx], float)
        pred = np.asarray(predictions[idx], float)
        panel = Panel(boxes[i * 2 + j], (0.0, float(len(true))))
        _axes(cv, panel, "Fit = {:0.3f}".format(metric[idx]),
              (0, len(true) // 2, len(true)))
        _curve(cv, panel, np.arange(len(true)), true, BLUE, 2)
        _curve(cv, panel, np.arange(len(pred)), pred, CYAN, 2)
        panels.append(panel)
    write_png(fig_path, cv.img)
    return panels


def plot_eval(pred_sort: Sequence[Sequence[float]],
              ccc_sort: Sequence[float],
              actual_sort: Sequence[Sequence[float]],
              seq_sort: Sequence[str], fig_path: str,
              window_size: float = 5) -> list:
    """10-panel prediction-vs-truth grid with CCC titles (reference
    plot_eval, train.py:281-315): values rescaled from [0, 1] to [-1, 1],
    time k * window_size on x (the data's range with matplotlib's 5%
    margins), prediction in red and truth in blue, 2 points wide, a
    legend, "valence(0-1)" and "time(s)" labels, titled
    "ccc=0.123-vid=...".  Returns the panels drawn."""
    cv = Canvas(18 * DPI, 7 * DPI)
    boxes = _grid(18 * DPI, 7 * DPI, 2, 5, (78, 40, 16, 48))
    panels = []
    for i in range(min(10, len(pred_sort))):
        ccc = ccc_sort[i]
        pred = list(pred_sort[i])
        actual = list(actual_sort[i])
        m = min(len(pred), len(actual))
        pred = [(p - 0.5) * 2.0 for p in pred[:m]]
        actual = [(a - 0.5) * 2.0 for a in actual[:m]]
        t = [k * window_size for k in range(m)]
        span = (t[-1] - t[0]) if m > 1 else 1.0
        lo = (t[0] if m else 0.0) - 0.05 * span
        panel = Panel(boxes[i], (lo, lo + 1.1 * span))
        _axes(cv, panel, "ccc=" + str(ccc)[:5] + "-vid=" + seq_sort[i],
              (t[0], t[m // 2], t[-1]) if m else (), xlabel="time(s)",
              ylabel="valence(0-1)")
        _curve(cv, panel, t, pred, RED, 3)
        _curve(cv, panel, t, actual, BLUE, 3)
        _legend(cv, panel.box)
        panels.append(panel)
    write_png(fig_path, cv.img)
    return panels


def _legend(cv: Canvas, box) -> None:
    """matplotlib's upper-right legend: a framed box with a line sample
    and a label for each curve."""
    left, top, right, bottom = box
    x1, y0 = right - 6, top + 6
    x0, y1 = x1 - 96, y0 + 30
    cv.fill(x0, y0, x1, y1, WHITE)
    for a, b, c, d in ((x0, y0, x1, y0 + 1), (x0, y1 - 1, x1, y1),
                       (x0, y0, x0 + 1, y1), (x1 - 1, y0, x1, y1)):
        cv.fill(a, b, c, d, GREY)
    for k, (label, color) in enumerate((("Prediction", RED), ("True", BLUE))):
        yy = y0 + 8 + 13 * k
        cv.fill(x0 + 5, yy, x0 + 25, yy + 3, color)
        cv.text(label, x0 + 30, yy - 2)
