"""Kernel 10's wgmma route, as far as the CPU reaches it: its arithmetic in
PyTorch (`window_embed_tiled_plain`), its weight layout and its route
selector.

  * `window_embed_tiled_plain` against the JAX package's Pallas kernel
    `fused_window_embed_highway(..., interpret=True)` in float32, atol 1e-5,
    and against `window_embed_highway_plain` in float64 within 1e-12, at F
    in {2, 3, 4, 5, 32} (R rows a window, R != F - 1 included), D of 5, 24
    and 300, E off every multiple of 32, and N not a multiple of a tile's
    windows;
  * `tiled_weight` lays the conv weight out as [2, E_pad, D_pad], W0 then
    W1, exactly zero in its pads;
  * `route` sends each dtype and alignment where the module docstring says,
    as a pure function of (dtype, N, F, D, E, the addresses) and of the
    library's plan (a stand-in here: the shape test lives in
    csrc/window_embed.cu and is checked on the card), and `tiled_shape`
    gives the kernel's widths.

The kernel itself runs only on the card (tests/test_torch_kernels_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multimodal_transformer_tpu.ops.pallas.window_embed as jwe
from multimodal_transformer_tpu_torch.ops.cuda import window_embed as we
from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401


NAMES = ("x", "conv_w", "conv_b", "wp", "bp", "wg", "bg")


def _case(seed, B, W, F, D, E, dtype=np.float32):
    rs = np.random.RandomState(seed)
    k1, k2 = (2 * D) ** -0.5, E ** -0.5
    arrs = {"x": rs.randn(B, W, F, D),
            "conv_w": rs.uniform(-k1, k1, (E, D, 2)),
            "conv_b": rs.uniform(-k1, k1, E),
            "wp": rs.uniform(-k2, k2, (E, E)), "bp": rs.uniform(-k2, k2, E),
            "wg": rs.uniform(-k2, k2, (E, E)), "bg": rs.uniform(-k2, k2, E)}
    return {k: v.astype(dtype) for k, v in arrs.items()}


def _torch_args(a):
    return [torch.from_numpy(a[k]) for k in NAMES]


# (B, W, F, D, E, tile_n): N = B * W windows, never a multiple of the
# wgmma route's 128 / R windows a tile; R = 1, 2, 4, 4 (R != F - 1), 32
SHAPES = [(2, 5, 2, 24, 13, 4), (3, 7, 3, 5, 40, 8), (1, 6, 4, 24, 33, 4),
          (2, 3, 5, 300, 45, 8), (1, 3, 32, 300, 20, 8)]


@pytest.mark.parametrize("shape", SHAPES)
def test_tiled_plain_matches_pallas_interpret(shape):
    B, W, F, D, E, tile_n = shape
    a = _case(0, B, W, F, D, E)
    conv = {"weight": jnp.asarray(a["conv_w"]),
            "bias": jnp.asarray(a["conv_b"])}
    hw = {"linear_projection": {"weight": jnp.asarray(a["wp"]),
                                "bias": jnp.asarray(a["bp"])},
          "linear_gate": {"weight": jnp.asarray(a["wg"]),
                          "bias": jnp.asarray(a["bg"])}}
    want = jwe.fused_window_embed_highway(conv, hw, jnp.asarray(a["x"]),
                                          tile_n=tile_n, interpret=True)
    got = we.window_embed_tiled_plain(*_torch_args(a))
    assert got.shape == (B, W, E) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_tiled_plain_matches_plain_float64(shape):
    B, W, F, D, E, _ = shape
    args = _torch_args(_case(1, B, W, F, D, E, np.float64))
    got = we.window_embed_tiled_plain(*args)
    want = we.window_embed_highway_plain(*args)
    assert got.dtype == torch.float64
    assert (got - want).abs().max().item() <= 1e-12


@pytest.mark.parametrize("shape", SHAPES)
def test_tiled_weight_is_zero_in_its_pads(shape):
    _, _, F, D, E, _ = shape
    conv_w = torch.from_numpy(_case(2, 1, 1, F, D, E)["conv_w"])
    R, E_pad, D_pad = we.tiled_shape(F, D, E)
    w = we.tiled_weight(conv_w, E_pad, D_pad)
    assert w.shape == (2, E_pad, D_pad) and w.is_contiguous()
    assert E_pad % 32 == 0 and E_pad >= E and D_pad % 32 == 0 and D_pad >= D
    assert torch.equal(w[0, :E, :D], conv_w[:, :, 0])
    assert torch.equal(w[1, :E, :D], conv_w[:, :, 1])
    pads = torch.ones_like(w, dtype=torch.bool)
    pads[:, :E, :D] = False
    assert torch.count_nonzero(w[pads]) == 0


# (F, D, E) whose weight needs no padding: E an instantiated width, D a
# multiple of TILED_BK
@pytest.mark.parametrize("F, D, E", [(4, 64, 64), (4, 32, 256), (32, 96, 320)])
def test_tiled_weight_without_pads_is_contiguous(F, D, E):
    conv_w = torch.from_numpy(_case(3, 1, 1, F, D, E)["conv_w"])
    assert we.tiled_shape(F, D, E)[1:] == (E, D)
    w = we.tiled_weight(conv_w, E, D)
    assert w.shape == (2, E, D) and w.is_contiguous()
    assert torch.equal(w, conv_w.permute(2, 0, 1))


# (F, D, E, (R, E_pad, D_pad)): E pads to the next of the front ends'
# widths 32, 64, 96, 256, 320 (E = 20, 44, 88, 256, 300)
@pytest.mark.parametrize("F, D, E, want", [
    (2, 88, 88, (1, 96, 96)), (3, 12, 40, (2, 64, 32)),
    (4, 88, 88, (4, 96, 96)), (4, 1000, 256, (4, 256, 1024)),
    (5, 20, 20, (4, 32, 32)), (32, 300, 300, (32, 320, 320)),
    (4, 88, 44, (4, 64, 96)), (33, 88, 129, (32, 256, 96)),
    (34, 88, 300, (64, 320, 96)), (65, 300, 300, (64, 320, 320)),
    (3, 8, 321, (2, None, 32))])
def test_tiled_shape(F, D, E, want):
    assert we.tiled_shape(F, D, E) == want


BF16, F32 = torch.bfloat16, torch.float32


class _Lib:
    """A stand-in library whose wgmma-route plan query answers `takes`
    (with a made-up plan) and records what it was asked."""

    def __init__(self, takes):
        self.takes, self.asked = takes, []

    def mmtx_window_embed_tiled_plan(self, N, F, D, E, out):
        self.asked.append((N, F, D, E))
        if self.takes:
            out[:] = list(range(1, len(we.PLAN_KEYS) + 1))
        return int(self.takes)


def _use(monkeypatch, lib):
    """Makes `lib` the library that the wrapper loads."""
    monkeypatch.setattr(we._build, "load", lambda *a, **k: lib)
    return lib


# (dtype, addresses of x, wp and wg, the library's answer, route): the shape
# test is the library's (csrc/window_embed.cu `plan`, checked at every front
# end on the card); bf16 takes its answer, fp32 and an x or a weight off 8
# bytes keep the tiles route without asking
@pytest.mark.parametrize("dtype, ptrs, takes, want", [
    (BF16, (0, 0, 0), True, "wgmma"),
    (BF16, (256, 512, 1024), True, "wgmma"),
    (BF16, (8, 8, 8), False, "tiles"),
    (F32, (0, 0, 0), True, "tiles"),
    (torch.float64, (0, 0, 0), True, "tiles"),
    (BF16, (4, 0, 0), True, "tiles"),
    (BF16, (0, 2, 0), True, "tiles"),
    (BF16, (0, 0, 6), True, "tiles")])
def test_route(monkeypatch, dtype, ptrs, takes, want):
    lib = _use(monkeypatch, _Lib(takes))
    assert we.route(dtype, 5120, 32, 300, 300, *ptrs) == want
    asks = dtype == BF16 and all(p % 8 == 0 for p in ptrs)
    assert lib.asked == ([(5120, 32, 300, 300)] if asks else [])


def test_route_asks_the_library_only_for_bf16(monkeypatch):
    lib = _use(monkeypatch, _Lib(True))
    assert we.route(F32, 37, 4, 88, 88, 0, 0, 0) == "tiles"
    assert we.route(BF16, 37, 4, 88, 88, 0, 0, 0) == "wgmma"
    assert lib.asked == [(37, 4, 88, 88)]


@pytest.mark.parametrize("takes", [True, False])
def test_tiled_plan_reads_the_library(monkeypatch, takes):
    _use(monkeypatch, _Lib(takes))
    plan = we.tiled_plan(17920, 32, 300, 300)
    if takes:
        assert plan == {k: i + 1 for i, k in enumerate(we.PLAN_KEYS)}
    else:
        assert plan is None


def test_cpu_call_is_the_plain_version_and_counts_no_launch():
    a = _case(3, 2, 3, 4, 24, 20)
    we.reset_launches()
    got = we.window_embed_highway(*_torch_args(a))
    assert torch.equal(got, we.window_embed_highway_plain(*_torch_args(a)))
    assert we.launches == 0
    assert we.launches_by_route == {"wgmma": 0, "tiles": 0}
