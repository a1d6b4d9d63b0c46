"""Check each CUDA kernel against its plain version on the card.

The bound is competitive: with `ref` the plain version run in float64 on
the same (already rounded) inputs and weights,

    max|kernel - ref| <= 2 * max|plain - ref| + 1e-6

where `plain` is the plain version in the kernel's own dtype.  Errors are
taken over valid rows only (rows past a video's length are garbage in every
implementation).  Used by chip_smoke.py and tests/test_torch_kernels_cuda.py.
"""

from __future__ import annotations

import copy
import dataclasses
import statistics

import numpy as np
import torch

from ...models.config import MFT_EMBED_DIM
from ..attention import Encoder
from ..mfn_core import MFN, hoisted_inputs
from . import encoder as enc_k
from . import mfn as mfn_k

SLACK = 1e-6
AVL = ("acoustic", "image", "linguistic")


@dataclasses.dataclass
class KernelCheck:
    name: str
    shape: str
    dtype: str
    err: float          # max |kernel - fp64 plain| on valid rows
    plain_err: float    # max |plain in dtype - fp64 plain| on valid rows
    nan_free: bool
    ms: float           # kernel time, median of warm repeats
    plain_ms: float

    @property
    def bound(self) -> float:
        return 2.0 * self.plain_err + SLACK

    @property
    def ok(self) -> bool:
        return self.nan_free and self.err <= self.bound

    def line(self) -> str:
        return (f"{self.name:22s} {self.shape:18s} {self.dtype:9s} "
                f"err={self.err:.3e} bound={self.bound:.3e} "
                f"(plain err {self.plain_err:.3e}) "
                f"kernel={self.ms:.3f} ms plain={self.plain_ms:.3f} ms "
                f"{'PASS' if self.ok else 'FAIL'}")


def time_ms(fn, reps: int = 7, warmup: int = 2) -> float:
    """Median milliseconds of fn() over reps calls, timed with CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def lengths_for(B: int, T: int, seed: int) -> np.ndarray:
    """Varied lengths in 1..T, always including T and 1."""
    rs = np.random.RandomState(seed)
    lens = rs.randint(1, T + 1, size=B)
    lens[0], lens[-1] = T, 1
    return lens


def _max_err(a: torch.Tensor, ref: torch.Tensor, valid: torch.Tensor) -> float:
    return (a.double() - ref)[valid].abs().max().item()


def random_encoder(gen: torch.Generator, D: int = 256, F: int = 128,
                   n_layers: int = 6) -> Encoder:
    """An encoder whose layers and norms all differ (unlike the cloned init
    of a fresh model), so that a layer mix-up cannot pass."""
    enc = Encoder(D, F, n_layers)
    with torch.no_grad():
        for p in enc.parameters():
            if p.dim() == 2:
                p.uniform_(-1.0, 1.0, generator=gen).mul_(p.shape[1] ** -0.5)
            else:
                p.normal_(0.0, 0.1, generator=gen)
        for name, p in enc.named_parameters():
            if name.endswith("a_2"):
                p.add_(1.0)
    return enc


@torch.no_grad()
def check_encoder(B: int, T: int, dtype: torch.dtype, *, device, seed: int = 0,
                  D: int = 256, h: int = 8, F: int = 128, n_layers: int = 6,
                  reps: int = 7) -> KernelCheck:
    gen = torch.Generator().manual_seed(seed)
    enc = random_encoder(gen, D, F, n_layers).to(device=device, dtype=dtype)
    x = torch.randn(B, T, D, generator=gen).to(device=device, dtype=dtype)
    lens = torch.as_tensor(lengths_for(B, T, seed))
    mask = (torch.arange(T)[None, :] < lens[:, None]).to(dtype)[..., None]
    mask = mask.to(device)
    valid = mask[..., 0].bool()

    ref = enc_k.encoder_stack_fused_plain(copy.deepcopy(enc).double(),
                                          x.double(), mask.double(), h=h)
    plain = enc_k.encoder_stack_fused_plain(enc, x, mask, h=h)
    kern = enc_k.encoder_stack_fused(enc, x, mask, h=h)
    torch.cuda.synchronize()
    nan_free = bool(torch.isfinite(kern.float()[valid]).all())
    return KernelCheck(
        "encoder_stack_fused", f"B={B} T={T} D={D}", str(dtype).split(".")[-1],
        _max_err(kern, ref, valid), _max_err(plain, ref, valid), nan_free,
        time_ms(lambda: enc_k.encoder_stack_fused(enc, x, mask, h=h), reps),
        time_ms(lambda: enc_k.encoder_stack_fused_plain(enc, x, mask, h=h), reps))


@torch.no_grad()
def check_mfn(B: int, T: int, dtype: torch.dtype, *, device, seed: int = 0,
              mods=AVL, reps: int = 5) -> KernelCheck:
    gen = torch.Generator().manual_seed(seed)
    mfn = MFN(mods, MFT_EMBED_DIM, output_dim=1, gen=gen).to(device=device,
                                                            dtype=dtype)
    inputs = {m: torch.randn(B, T, MFT_EMBED_DIM[m], generator=gen).to(
        device=device, dtype=dtype) for m in mods}
    xps = [x.contiguous() for x in hoisted_inputs(mfn, inputs)]
    whhs = [getattr(mfn, f"lstm_{m}").weight_hh.detach() for m in mods]
    gates = [g.detach() for g in mfn.gate_tensors()]

    ref = mfn_k.mfn_scan_fused_plain([t.double() for t in xps],
                                     [t.double() for t in whhs],
                                     [t.double() for t in gates])
    plain = mfn_k.mfn_scan_fused_plain(xps, whhs, gates)
    kern = mfn_k.mfn_scan_fused(xps, whhs, gates)
    torch.cuda.synchronize()
    ref_c, plain_c, kern_c = (torch.cat(o, dim=-1) for o in (ref, plain, kern))
    valid = torch.ones(ref_c.shape, dtype=torch.bool, device=ref_c.device)
    nan_free = bool(torch.isfinite(kern_c.float()).all())
    return KernelCheck(
        "mfn_scan_fused", f"B={B} T={T} A+V+L", str(dtype).split(".")[-1],
        _max_err(kern_c, ref_c, valid), _max_err(plain_c, ref_c, valid),
        nan_free,
        time_ms(lambda: mfn_k.mfn_scan_fused(xps, whhs, gates), reps),
        time_ms(lambda: mfn_k.mfn_scan_fused_plain(xps, whhs, gates), reps,
                warmup=1))
