"""Check each CUDA kernel against its plain version on the card.

The bound is competitive and applies to every output tensor: with `ref` the
plain version run in float64 on the same (already rounded) inputs and
weights,

    max|kernel - ref| <= 2 * max|plain - ref| + 1e-6

where `plain` is the plain version in the kernel's own dtype.  Errors are
taken over valid rows only (rows past a video's length are garbage in every
implementation).  Used by chip_smoke.py and tests/test_torch_kernels_cuda.py.

Each check also carries the kernel's bound: the least time an H100 SXM could
take for the same work, the larger of the bytes it must move (every input
read once, every output written once) over 3.35 TB/s and its operations over
the peak rate of their type (989 TFLOP/s for bf16 products on the tensor
cores, 67 TFLOP/s for float32 products, which the rounding points keep off
TF32), counted from the check's shapes.
"""

from __future__ import annotations

import copy
import dataclasses
import math
import statistics
from typing import Dict, Tuple

import numpy as np
import torch

from ...models.config import MFT_EMBED_DIM
from ..attention import Encoder
from ..basic import conv1d_window_embed, highway_fn
from ..mfn_core import DROPOUTS, MFN, hoisted_inputs
from . import encoder as enc_k
from . import encoder_train as enct_k
from . import flash_attention as fa_k
from . import mfn as mfn_k
from . import mfn_train as mfnt_k
from . import mfn_variants as mfnv_k
from . import window_embed as we_k

SLACK = 1e-6
AVL = ("acoustic", "image", "linguistic")
ENC_P = 0.1
MFN_PS = (DROPOUTS["gamma1"], DROPOUTS["gamma2"])
TRAIN_LAYERS = 6
KERNEL_BURST = 5  # back-to-back kernel calls per timed window
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "fp32": 67e12}


@dataclasses.dataclass
class KernelCheck:
    name: str
    shape: str
    dtype: str
    parts: Dict[str, Tuple[float, float]]  # output -> (err, plain err)
    nan_free: bool
    ms: float           # kernel ms per call, median of warm bursts (nan: untimed)
    plain_ms: float
    ops_ms: float = math.nan    # operations / peak rate of their type
    bytes_ms: float = math.nan  # bytes moved / HBM rate
    library_ms: float = math.nan  # one PyTorch call of the same function
    identical: bool | None = None  # bit-identical to its reference kernel
    # (reference kernel, max |kernel - reference|, its limit)
    reference: Tuple[str, float, float] | None = None

    @property
    def bound_ms(self) -> float:
        return max(self.ops_ms, self.bytes_ms)

    @property
    def bound_by(self) -> str:
        return "operations" if self.ops_ms >= self.bytes_ms else "bytes"

    @staticmethod
    def bound_of(plain_err: float) -> float:
        return 2.0 * plain_err + SLACK

    @property
    def err(self) -> float:
        """max |kernel - fp64 plain| over every output tensor."""
        return max(e for e, _ in self.parts.values())

    @property
    def worst(self) -> str:
        """The output closest to (or furthest past) its bound."""
        return max(self.parts, key=lambda k: self.parts[k][0]
                   / self.bound_of(self.parts[k][1]))

    @property
    def ok(self) -> bool:
        return (self.nan_free and self.identical is not False
                and (self.reference is None
                     or self.reference[1] <= self.reference[2])
                and all(e <= self.bound_of(p) for e, p in self.parts.values()))

    def line(self) -> str:
        e, p = self.parts[self.worst]
        library = ("" if math.isnan(self.library_ms)
                   else f"library={self.library_ms:.3f} ms ")
        if self.identical is not None:
            library += f"bit-identical={self.identical} "
        if self.reference is not None:
            ref, diff, limit = self.reference
            library += f"|kernel - {ref}|={diff:.3e} (limit {limit:.0e}) "
        return (f"{self.name:24s} {self.shape:18s} {self.dtype:9s} "
                f"{len(self.parts):2d} outputs, worst {self.worst}: "
                f"err={e:.3e} bound={self.bound_of(p):.3e} "
                f"(plain err {p:.3e}) kernel={self.ms:.3f} ms "
                f"plain={self.plain_ms:.3f} ms {library}"
                f"bound={self.bound_ms:.4f} ms "
                f"({self.bound_by}) {'PASS' if self.ok else 'FAIL'}")


def bound_times(ops: Dict[str, float], tensors) -> Tuple[float, float]:
    """(ops_ms, bytes_ms): ops maps a product type ("bf16" or "fp32") to its
    operation count; tensors are the inputs and outputs, each moved once.
    bf16 products run on the tensor cores and float32 ones on the FMA pipes,
    units that work at the same time, so ops_ms is the slower unit's time."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    return (1e3 * max(n / PEAK_OPS_PER_S[k] for k, n in ops.items()),
            1e3 * nbytes / HBM_BYTES_PER_S)


def _ops_type(dtype: torch.dtype) -> str:
    return "bf16" if dtype == torch.bfloat16 else "fp32"


def encoder_layer_ops(B: int, T: int, D: int, F: int) -> float:
    """One encoder layer's forward: the q/k/v/out projections, the FFN and
    the two attention products over every key."""
    return 2.0 * B * T * (4 * D * D + 2 * D * F) + 4.0 * B * T * T * D


def mfn_step_ops(whhs, gates) -> float:
    """One video-step of the MFN recurrence: the LSTM hidden products and
    the eight gate-MLP layers."""
    macs = sum(w.shape[0] * w.shape[1] for w in whhs)
    macs += sum(g.shape[0] * g.shape[1] for g in gates[0::2])
    return 2.0 * macs


def runs_ms(fn, reps: int = 7, warmup: int = 2, burst: int = 1) -> list:
    """Milliseconds per fn() call of each of reps runs, timed with CUDA
    events: a run is a burst of back-to-back calls divided by its length (a
    burst keeps the card's queue full, so the host's per-call preparation
    after the first call overlaps the card's work)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(burst):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / burst)
    return times


def time_ms(fn, reps: int = 7, warmup: int = 2, burst: int = 1) -> float:
    """The median of `runs_ms`; nan when reps is 0."""
    if reps <= 0:
        return math.nan
    return statistics.median(runs_ms(fn, reps, warmup, burst))


def lengths_for(B: int, T: int, seed: int) -> np.ndarray:
    """Varied lengths in 1..T, always including T and 1."""
    rs = np.random.RandomState(seed)
    lens = rs.randint(1, T + 1, size=B)
    lens[0], lens[-1] = T, 1
    return lens


def _max_err(a: torch.Tensor, ref: torch.Tensor, valid=None) -> float:
    d = (a.double() - ref.double()).abs()
    return (d[valid] if valid is not None else d).max().item()


def _parts(names, kern, plain, ref, valids) -> Dict[str, Tuple[float, float]]:
    return {n: (_max_err(k, r, v), _max_err(p, r, v))
            for n, k, p, r, v in zip(names, kern, plain, ref, valids)}


def _finite(ts, valids) -> bool:
    return all(bool(torch.isfinite((t if v is None else t[v]).float()).all())
               for t, v in zip(ts, valids))


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).split(".")[-1]


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


def random_seeds(gen: torch.Generator, *shape) -> torch.Tensor:
    return torch.randint(0, 2 ** 32, shape, generator=gen, dtype=torch.int64)


def _key_mask(B: int, T: int, seed: int, dtype, device):
    lens = torch.as_tensor(lengths_for(B, T, seed))
    mask = (torch.arange(T)[None, :] < lens[:, None]).to(dtype)[..., None]
    return mask.to(device)


def _encoder_case(B, T, dtype, device, seed, D, F, n_layers):
    """A random encoder, x and the key mask: varied lengths in a batch, the
    whole video at B=1 (as evaluate_per_video calls it)."""
    gen = torch.Generator().manual_seed(seed)
    enc = random_encoder(gen, D, F, n_layers).to(device=device, dtype=dtype)
    x = torch.randn(B, T, D, generator=gen).to(device=device, dtype=dtype)
    mask = (_key_mask(B, T, seed, dtype, device) if B > 1 else
            torch.ones(B, T, 1, device=device, dtype=dtype))
    return enc, x, mask


@torch.no_grad()
def check_encoder(B: int, T: int, dtype: torch.dtype, *, device, seed: int = 0,
                  D: int = 256, h: int = 8, F: int = 128, n_layers: int = 6,
                  reps: int = 7, repeat: bool = False) -> KernelCheck:
    """Kernel A against its plain version; repeat: also call the kernel
    again and require the same bits."""
    enc, x, mask = _encoder_case(B, T, dtype, device, seed, D, F, n_layers)
    valid = mask[..., 0].bool()

    ref = enc_k.encoder_stack_fused_plain(copy.deepcopy(enc).double(),
                                          x.double(), mask.double(), h=h)
    plain = enc_k.encoder_stack_fused_plain(enc, x, mask, h=h)
    kern = enc_k.encoder_stack_fused(enc, x, mask, h=h)
    identical = None
    if repeat:
        identical = torch.equal(kern, enc_k.encoder_stack_fused(enc, x, mask,
                                                                h=h))
    torch.cuda.synchronize()
    return KernelCheck(
        "encoder_stack_fused", f"B={B} T={T} D={D}", _dtype_name(dtype),
        _parts(["out"], [kern], [plain], [ref], [valid]),
        _finite([kern], [valid]),
        time_ms(lambda: enc_k.encoder_stack_fused(enc, x, mask, h=h), reps,
                burst=KERNEL_BURST),
        time_ms(lambda: enc_k.encoder_stack_fused_plain(enc, x, mask, h=h),
                reps),
        *bound_times({_ops_type(dtype): n_layers * encoder_layer_ops(B, T, D,
                                                                     F)},
                     [x, mask, kern, *enc.parameters()]),
        identical=identical)


def kernel_device_ms(fn, calls: int, name_of, per_launch: bool = False,
                     seen: Dict[str, int] | None = None) -> Dict[str, float]:
    """Device ms per call of fn's kernels, from torch.profiler's kernel
    events over `calls` calls after a warm one (the window padded by
    engine.profiling.pad_window, whose kernels are left out, so that no
    event is dropped), summed by name_of(event name) (events it maps to
    None are left out); per_launch: the mean ms of a name's events instead,
    which for kernels launched once a call is their ms per call even when
    the profiler drops some events; seen, where given, receives the number
    of events captured of each name."""
    from torch.profiler import ProfilerActivity, profile

    from ...engine.profiling import PAD_KERNEL_MARK, pad_window

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        pad_window(start=True)
        for _ in range(calls):
            fn()
        pad_window(start=False)
    out: Dict[str, float] = {}
    seen = {} if seen is None else seen
    for e in prof.events():
        key = (name_of(e.name) if str(e.device_type).endswith("CUDA")
               and PAD_KERNEL_MARK not in e.name else None)
        if key is not None:
            out[key] = out.get(key, 0.0) + (
                e.time_range.end - e.time_range.start) / 1e3
            seen[key] = seen.get(key, 0) + 1
    return {k: v / (seen[k] if per_launch else calls) for k, v in out.items()}


@torch.no_grad()
def encoder_kernel_ms(B: int, T: int, dtype: torch.dtype, *, device,
                      seed: int = 0, calls: int = 5) -> Dict[str, float]:
    """Device ms per stack of each of kernel A's kernels (by name, template
    arguments included) over `calls` warm calls at D=256, h=8, F=128, 6
    layers."""
    enc, x, mask = _encoder_case(B, T, dtype, device, seed, 256, 128, 6)
    out = kernel_device_ms(
        lambda: enc_k.encoder_stack_fused(enc, x, mask), calls,
        lambda n: (n.split("mmtx::", 1)[1].split("(", 1)[0]
                   if "mmtx::" in n else None))
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def _launch_name(name: str):
    """A profiler event's launch name: a kernel of the port's namespace with
    its template arguments, device-to-device copies as "Memcpy DtoD", else
    None (left out)."""
    if "mmtx::" in name:
        return name.split("mmtx::", 1)[1].split("(", 1)[0]
    return "Memcpy DtoD" if "Memcpy DtoD" in name else None


def encoder_bwd_kernel_ms(B: int, T: int, dtype: torch.dtype, *, device,
                          seed: int = 0, calls: int = 5, p: float = ENC_P
                          ) -> Dict[str, Tuple[float, int]]:
    """(device ms per call, events captured) of each launch name of kernel
    4 (one layer's backward, template arguments included; device-to-device
    copies as "Memcpy DtoD") over `calls` warm calls at D=256, h=8, F=128.
    Each of the wgmma path's kernels launches once a call, so its reading is
    the mean of its launches (it holds when the profiler drops events); the
    FMA path's names launch several times a call and are summed over the
    calls, so a dropped event lowers them: the count shows it."""
    gen, lp, _, kmask, seeds = _encoder_train_case(B, T, dtype, device, seed,
                                                   256, 128, 1)
    x = torch.randn(B, T, 256, generator=gen).to(device)
    dy = torch.randn(B, T, 256, generator=gen).to(device) * kmask[..., None]
    seen: Dict[str, int] = {}
    with torch.no_grad():
        out = kernel_device_ms(
            lambda: enct_k.encoder_layer_bwd(lp, x, dy, kmask, seeds[0], p, 8),
            calls, _launch_name,
            per_launch=enc_k.kernel_path(dtype, 32, 256, 128)
            == enc_k.PATH_WGMMA, seen=seen)
    return {k: (v, seen[k]) for k, v in sorted(out.items(),
                                               key=lambda kv: -kv[1])}


@torch.no_grad()
def encoder_train_fwd_kernel_ms(B: int, T: int, dtype: torch.dtype, *, device,
                                seed: int = 0, calls: int = 5,
                                p: float = ENC_P
                                ) -> Dict[str, Tuple[float, int]]:
    """(device ms per call, events captured) of each launch name of kernel
    3 (template arguments included; device-to-device copies as "Memcpy
    DtoD") over `calls` warm calls at D=256, h=8, F=128, 6 layers.  A name's
    events are summed over the calls, so an event the profiler drops lowers
    its reading: on the wgmma path each call launches 7 row chains and 6
    attentions, and the counts show it."""
    _, params, x, kmask, seeds = _encoder_train_case(B, T, dtype, device,
                                                     seed, 256, 128,
                                                     TRAIN_LAYERS)
    seen: Dict[str, int] = {}
    out = kernel_device_ms(
        lambda: enct_k.encoder_stack_train_fwd(params, x, kmask, seeds, p, 8),
        calls, _launch_name, seen=seen)
    return {k: (v, seen[k]) for k, v in sorted(out.items(),
                                               key=lambda kv: -kv[1])}


MOD_LETTER = {"acoustic": "A", "image": "V", "linguistic": "L",
              "emotient": "E"}


def _mfn_case(B, T, dtype, device, seed, mods):
    """An MFN with the MFT's embed widths as inputs, and its hoisted xps,
    W_hh list and gate tensors in dtype on device."""
    gen = torch.Generator().manual_seed(seed)
    mfn = MFN(mods, MFT_EMBED_DIM, output_dim=1, gen=gen).to(device=device,
                                                            dtype=dtype)
    with torch.no_grad():
        inputs = {m: torch.randn(B, T, MFT_EMBED_DIM[m], generator=gen).to(
            device=device, dtype=dtype) for m in mods}
        xps = [x.contiguous() for x in hoisted_inputs(mfn, inputs)]
    whhs = [getattr(mfn, f"lstm_{m}").weight_hh.detach() for m in mods]
    gates = [g.detach() for g in mfn.gate_tensors()]
    return gen, xps, whhs, gates


@torch.no_grad()
def _check_mfn_scan(name, kernel, plain_fn, B, T, dtype, device, seed, mods,
                    reps, repeat: bool = False, same_as=None, near=None,
                    label: str = "", timed=None) -> KernelCheck:
    """A kernel of kernel B's function (hs, mems) against its plain
    version; the bound is kernel B's work, whatever the layout.  repeat:
    also call the kernel again and require the same bits; same_as: a kernel
    whose outputs it must equal bit for bit; near: (kernel, limit), a kernel
    it must be within limit of on every output; timed: what is timed in the
    kernel's place (default the kernel)."""
    _, xps, whhs, gates = _mfn_case(B, T, dtype, device, seed, mods)
    ref = plain_fn(_double(xps), _double(whhs), _double(gates))
    plain = plain_fn(xps, whhs, gates)
    kern = kernel(xps, whhs, gates)
    identical = reference = None
    if repeat:
        identical = all(torch.equal(a, b) for a, b in
                        zip(kern, kernel(xps, whhs, gates)))
    if same_as is not None:
        identical = identical is not False and all(
            torch.equal(a, b) for a, b in zip(kern, same_as(xps, whhs, gates)))
    if near is not None:
        other = near[0](xps, whhs, gates)
        reference = (near[0].__name__,
                     max(_max_err(a, b) for a, b in zip(kern, other)), near[1])
    torch.cuda.synchronize()
    return KernelCheck(
        name, f"{label}B={B} T={T} {'+'.join(MOD_LETTER[m] for m in mods)}",
        _dtype_name(dtype), _parts(["hs", "mems"], kern, plain, ref,
                                   [None, None]),
        _finite(kern, [None, None]),
        time_ms(lambda: (timed or kernel)(xps, whhs, gates), reps,
                burst=KERNEL_BURST),
        time_ms(lambda: plain_fn(xps, whhs, gates), reps, warmup=1),
        *bound_times({"fp32": B * T * mfn_step_ops(whhs, gates)},
                     [*xps, *whhs, *gates, *kern]), identical=identical,
        reference=reference)


def check_mfn(B: int, T: int, dtype: torch.dtype, *, device, seed: int = 0,
              mods=AVL, reps: int = 5) -> KernelCheck:
    """Kernel B, also bit-identical when called again."""
    return _check_mfn_scan("mfn_scan_fused", mfn_k.mfn_scan_fused,
                           mfn_k.mfn_scan_fused_plain, B, T, dtype, device,
                           seed, mods, reps, repeat=True)


# kernel B's stages (and kernel 6's) by the names of their CUDA kernels
# (csrc/mfn.cu), in the order a name is matched: the LSTM scan, the memory
# scan, then the rest of the namespace (the GEMMs with kernel B's epilogue
# and the softmax)
MFN_STAGES = (("stage 1, LSTM scan", "lstm_scan_kernel"),
              ("stage 3, memory scan", "mem_scan_kernel"),
              ("stage 2, batched", "mfn_staged"))


@torch.no_grad()
def mfn_stage_ms(B: int, T: int, dtype: torch.dtype, *, device,
                 seed: int = 0, mods=AVL, calls: int = 5,
                 scan=None) -> Dict[str, float]:
    """Device ms per call of each of kernel B's stages over `calls` warm
    calls of scan (default kernel B; rows 8 and 9 launch the same stages,
    and their packing in torch is left out)."""
    scan = scan or mfn_k.mfn_scan_fused
    _, xps, whhs, gates = _mfn_case(B, T, dtype, device, seed, mods)
    out = kernel_device_ms(
        lambda: scan(xps, whhs, gates), calls,
        lambda n: next((stage for stage, key in MFN_STAGES if key in n), None))
    return {stage: out.get(stage, 0.0) for stage, _ in sorted(MFN_STAGES)}


def check_mfn_packed(B: int, T: int, dtype: torch.dtype, *, device,
                     seed: int = 0, mods=AVL, reps: int = 5) -> KernelCheck:
    """Row 8, the block-diagonal packing (zero blocks not counted in the
    bound): kernel B's stages on its views, so also bit-identical to kernel
    B and when called again."""
    return _check_mfn_scan("mfn_scan_packed", mfnv_k.mfn_scan_packed,
                           mfnv_k.mfn_scan_packed_plain, B, T, dtype, device,
                           seed, mods, reps, repeat=True,
                           same_as=mfn_k.mfn_scan_fused)


def check_mfn_aligned(B: int, T: int, dtype: torch.dtype, *, device,
                      seed: int = 0, mods=AVL, reps: int = 5,
                      hp: int = mfnv_k.ALIGN_HP) -> KernelCheck:
    """Row 9, hidden blocks padded to multiples of hp (pad lanes not
    counted in the bound), on a workspace filled with NaN before each call
    (a pad lane the kernel did not write would spoil every output); also
    bit-identical when called again, and within the MFN bench's tolerance
    (bench_mfn_kernel.TOLERANCE) of kernel B.  Its time is the wrapper's
    without the fill."""
    from ...bench_mfn_kernel import TOLERANCE

    def kernel(xps, whhs, gates):
        return mfnv_k.mfn_scan_aligned(xps, whhs, gates, hp, fill=math.nan)

    def timed(xps, whhs, gates):
        return mfnv_k.mfn_scan_aligned(xps, whhs, gates, hp)

    def plain(xps, whhs, gates):
        return mfnv_k.mfn_scan_aligned_plain(xps, whhs, gates, hp)

    return _check_mfn_scan(
        "mfn_scan_aligned", kernel, plain, B, T, dtype, device, seed, mods,
        reps, repeat=True,
        near=(mfn_k.mfn_scan_fused, TOLERANCE[_dtype_name(dtype)]),
        label="" if hp == mfnv_k.ALIGN_HP else f"hp={hp} ", timed=timed)


def _label(p, d_k: int = 32) -> str:
    """The shape label's prefix of a training check at a dropout rate or a
    head width other than the model's."""
    return ("" if p is None else f"p={p} ") + ("" if d_k == 32 else
                                               f"dk={d_k} ")


def _encoder_train_case(B, T, dtype, device, seed, D, F, n_layers):
    gen = torch.Generator().manual_seed(seed)
    enc = random_encoder(gen, D, F, n_layers).to(device=device, dtype=dtype)
    params = [t.detach() for layer in enc.layers
              for t in enct_k._layer_tensors(layer)]
    x = torch.randn(B, T, D, generator=gen).to(device=device, dtype=dtype)
    kmask = _key_mask(B, T, seed, torch.float32, device)[..., 0]
    seeds = random_seeds(gen, n_layers, 4)
    return gen, params, x, kmask, seeds


@torch.no_grad()
def check_encoder_train_fwd(B: int, T: int, dtype: torch.dtype, *, device,
                            seed: int = 0, D: int = 256, h: int = 8,
                            F: int = 128, n_layers: int = TRAIN_LAYERS,
                            reps: int = 5, p: float | None = None,
                            repeat: bool = False) -> KernelCheck:
    """Kernel 3: the stack's output and every layer's saved input; repeat:
    also call the kernel again and require the same bits."""
    rate = ENC_P if p is None else p
    _, params, x, kmask, seeds = _encoder_train_case(B, T, dtype, device,
                                                     seed, D, F, n_layers)
    valid = kmask.bool()
    args = (kmask, seeds, rate, h)
    ref = enct_k.encoder_stack_train_fwd_plain([p.double() for p in params],
                                               x.double(), *args)
    plain = enct_k.encoder_stack_train_fwd_plain(params, x, *args)
    kern = enct_k.encoder_stack_train_fwd(params, x, *args)
    identical = None
    if repeat:
        again = enct_k.encoder_stack_train_fwd(params, x, *args)
        identical = torch.equal(kern[0], again[0]) and torch.equal(kern[1],
                                                                   again[1])
    torch.cuda.synchronize()
    names = ["out"] + [f"saved[{l}]" for l in range(1, n_layers)]
    split = lambda o: [o[0]] + [o[1][l] for l in range(1, n_layers)]
    valids = [valid] * n_layers
    return KernelCheck(
        "encoder_stack_train_fwd", _label(p, D // h) + f"B={B} T={T} D={D}",
        _dtype_name(dtype),
        _parts(names, split(kern), split(plain), split(ref), valids),
        _finite(split(kern), valids),
        time_ms(lambda: enct_k.encoder_stack_train_fwd(params, x, *args),
                reps, burst=KERNEL_BURST),
        time_ms(lambda: enct_k.encoder_stack_train_fwd_plain(params, x,
                                                             *args), reps),
        *bound_times({_ops_type(dtype): n_layers * encoder_layer_ops(B, T, D,
                                                                     F)},
                     [x, kmask, *params, kern[0], kern[1][1:]]),
        identical=identical)


GRAD_NAMES = ("ln1.a", "ln1.b", "q.w", "q.b", "k.w", "k.b", "v.w", "v.b",
              "out.w", "out.b", "ln2.a", "ln2.b", "ff1.w", "ff1.b", "ff2.w",
              "ff2.b")


def check_encoder_layer_bwd(B: int, T: int, dtype: torch.dtype, *, device,
                            seed: int = 0, D: int = 256, h: int = 8,
                            F: int = 128, reps: int = 5,
                            p: float | None = None,
                            repeat: bool = False) -> KernelCheck:
    """Kernel 4: dx and the 16 parameter grads of one layer, from a random
    layer input and a random output cotangent that is 0 past each video's
    length; repeat: also call the kernel again and require the same
    bits."""
    rate = ENC_P if p is None else p
    gen, lp, _, kmask, seeds = _encoder_train_case(B, T, dtype, device, seed,
                                                   D, F, 1)
    x = torch.randn(B, T, D, generator=gen).to(device)
    dy = torch.randn(B, T, D, generator=gen).to(device) * kmask[..., None]
    valid = kmask.bool()
    args = (kmask, seeds[0], rate, h)
    ref = enct_k.encoder_layer_bwd_plain([p.double() for p in lp], x.double(),
                                         dy.double(), *args)
    plain = enct_k.encoder_layer_bwd_plain(lp, x, dy, *args)
    with torch.no_grad():
        kern = enct_k.encoder_layer_bwd(lp, x, dy, *args)
        identical = None
        if repeat:
            again = enct_k.encoder_layer_bwd(lp, x, dy, *args)
            identical = torch.equal(kern[0], again[0]) and all(
                torch.equal(a, b) for a, b in zip(kern[1], again[1]))
    torch.cuda.synchronize()
    flat = lambda o: [o[0]] + list(o[1])
    valids = [valid] + [None] * len(lp)
    return KernelCheck(
        "encoder_layer_bwd", _label(p, D // h) + f"B={B} T={T} D={D}",
        _dtype_name(dtype),
        _parts(("dx",) + GRAD_NAMES, flat(kern), flat(plain), flat(ref),
               valids),
        _finite(flat(kern), valids),
        time_ms(lambda: enct_k.encoder_layer_bwd(lp, x, dy, *args), reps,
                burst=KERNEL_BURST),
        time_ms(lambda: enct_k.encoder_layer_bwd_plain(lp, x, dy, *args),
                reps),
        # the layer's forward (recomputed: only its input is saved) and the
        # two products of the backward per forward product
        *bound_times({_ops_type(dtype): 3 * encoder_layer_ops(B, T, D, F)},
                     [x, dy, kmask, *lp, *flat(kern)]), identical=identical)


def check_encoder_stack_bwd(B: int, T: int, dtype: torch.dtype, *, device,
                            seed: int = 0, D: int = 256, h: int = 8,
                            F: int = 128, n_layers: int = TRAIN_LAYERS,
                            reps: int = 5,
                            p: float | None = None,
                            repeat: bool = False) -> KernelCheck:
    """Kernel 5: dx and the 16 stacked parameter grads of the whole stack,
    from kernel 3's saved layer inputs and a random output cotangent that is
    0 past each video's length; also bit-identical to kernel 4 called for
    every layer, last first, and (repeat) to itself called again
    (`identical`)."""
    rate = ENC_P if p is None else p
    gen, params, x, kmask, seeds = _encoder_train_case(B, T, dtype, device,
                                                       seed, D, F, n_layers)
    with torch.no_grad():
        _, saved = enct_k.encoder_stack_train_fwd(params, x, kmask, seeds,
                                                  rate, h)
    dy = torch.randn(B, T, D, generator=gen).to(device) * kmask[..., None]
    valid = kmask.bool()
    args = (kmask, seeds, rate, h)
    ref = enct_k.encoder_stack_bwd_plain(_double(params), saved.double(),
                                         dy.double(), *args)
    plain = enct_k.encoder_stack_bwd_plain(params, saved, dy, *args)
    with torch.no_grad():
        kern = enct_k.encoder_stack_bwd(params, saved, dy, *args)
        g, per_layer = dy, [None] * n_layers
        for l in reversed(range(n_layers)):
            g, per_layer[l] = enct_k.encoder_layer_bwd(
                params[enct_k.N_PARAMS * l:enct_k.N_PARAMS * (l + 1)],
                saved[l], g, kmask, seeds[l], rate, h)
    torch.cuda.synchronize()
    identical = torch.equal(kern[0], g) and all(
        torch.equal(a, torch.stack(b)) for a, b in zip(kern[1],
                                                       zip(*per_layer)))
    if repeat:
        with torch.no_grad():
            again = enct_k.encoder_stack_bwd(params, saved, dy, *args)
        identical = identical and torch.equal(kern[0], again[0]) and all(
            torch.equal(a, b) for a, b in zip(kern[1], again[1]))
    flat = lambda o: [o[0]] + list(o[1])
    valids = [valid] + [None] * enct_k.N_PARAMS
    c = KernelCheck(
        "encoder_stack_bwd", _label(p, D // h) + f"B={B} T={T} D={D}",
        _dtype_name(dtype),
        _parts(("dx",) + GRAD_NAMES, flat(kern), flat(plain), flat(ref),
               valids),
        _finite(flat(kern), valids),
        time_ms(lambda: enct_k.encoder_stack_bwd(params, saved, dy, *args),
                reps, burst=KERNEL_BURST),
        time_ms(lambda: enct_k.encoder_stack_bwd_plain(params, saved, dy,
                                                       *args), reps),
        # every layer's forward (recomputed from its saved input) and the
        # two products of the backward per forward product
        *bound_times({_ops_type(dtype): 3 * n_layers * encoder_layer_ops(
            B, T, D, F)}, [saved, dy, kmask, *params, *flat(kern)]))
    c.identical = identical
    return c


def _mfn_train_case(B, T, dtype, device, seed, mods):
    gen, xps, whhs, gates = _mfn_case(B, T, dtype, device, seed, mods)
    return gen, xps, whhs, gates, random_seeds(gen, T, 2)


def _double(ts):
    return [t.double() for t in ts]


@torch.no_grad()
def check_mfn_train_fwd(B: int, T: int, dtype: torch.dtype, *, device,
                        seed: int = 0, mods=AVL, reps: int = 5,
                        p: float | None = None,
                        repeat: bool = False) -> KernelCheck:
    """Kernel 6: hs, cs and mems; repeat: also call the kernel again and
    require the same bits."""
    ps = MFN_PS if p is None else (p, p)
    _, xps, whhs, gates, seeds = _mfn_train_case(B, T, dtype, device, seed,
                                                 mods)
    ref = mfnt_k.mfn_train_fwd_plain(_double(xps), _double(whhs),
                                     _double(gates), seeds, ps)
    plain = mfnt_k.mfn_train_fwd_plain(xps, whhs, gates, seeds, ps)
    kern = mfnt_k.mfn_train_fwd(xps, whhs, gates, seeds, ps)
    identical = None
    if repeat:
        identical = all(torch.equal(a, b) for a, b in zip(
            kern, mfnt_k.mfn_train_fwd(xps, whhs, gates, seeds, ps)))
    torch.cuda.synchronize()
    valids = [None] * 3
    return KernelCheck(
        "mfn_train_fwd",
        _label(p) + f"B={B} T={T} {'+'.join(MOD_LETTER[m] for m in mods)}",
        _dtype_name(dtype),
        _parts(["hs", "cs", "mems"], kern, plain, ref, valids),
        _finite(kern, valids),
        time_ms(lambda: mfnt_k.mfn_train_fwd(xps, whhs, gates, seeds, ps),
                reps, burst=KERNEL_BURST),
        time_ms(lambda: mfnt_k.mfn_train_fwd_plain(xps, whhs, gates, seeds,
                                                   ps), reps, warmup=1),
        *bound_times({"fp32": B * T * mfn_step_ops(whhs, gates)},
                     [*xps, *whhs, *gates, *kern]), identical=identical)


@torch.no_grad()
def mfn_train_fwd_stage_ms(B: int, T: int, dtype: torch.dtype, *, device,
                           seed: int = 0, mods=AVL, calls: int = 5,
                           p: float | None = None) -> Dict[str, float]:
    """Device ms per call of each of kernel 6's stages (kernel B's, by the
    names in MFN_STAGES) over `calls` warm calls, at the model's gamma
    dropout unless p is given."""
    ps = MFN_PS if p is None else (p, p)
    _, xps, whhs, gates, seeds = _mfn_train_case(B, T, dtype, device, seed,
                                                 mods)
    out = kernel_device_ms(
        lambda: mfnt_k.mfn_train_fwd(xps, whhs, gates, seeds, ps), calls,
        lambda n: next((stage for stage, key in MFN_STAGES if key in n), None))
    return {stage: out.get(stage, 0.0) for stage, _ in sorted(MFN_STAGES)}


def _mfn_train_bwd_case(B, T, dtype, device, seed, mods, ps):
    """Kernel 7's arguments: kernel 6's saved states of a random MFN and
    random cotangents, (xps, whhs, gates, seeds, ps, hs, cs, mems, g_hs,
    g_mems)."""
    gen, xps, whhs, gates, seeds = _mfn_train_case(B, T, dtype, device, seed,
                                                   mods)
    with torch.no_grad():
        hs, cs, mems = mfnt_k.mfn_train_fwd(xps, whhs, gates, seeds, ps)
    g_hs = torch.randn(hs.shape, generator=gen).to(device)
    g_mems = torch.randn(mems.shape, generator=gen).to(device)
    return xps, whhs, gates, seeds, ps, hs, cs, mems, g_hs, g_mems


def check_mfn_train_bwd(B: int, T: int, dtype: torch.dtype, *, device,
                        seed: int = 0, mods=AVL, reps: int = 3,
                        p: float | None = None,
                        repeat: bool = False) -> KernelCheck:
    """Kernel 7: d_xps and every parameter grad, from kernel 6's saved
    states (the same stored states feed all three versions) and random
    cotangents; repeat: also call the kernel again and require the same
    bits."""
    ps = MFN_PS if p is None else (p, p)
    args = _mfn_train_bwd_case(B, T, dtype, device, seed, mods, ps)
    xps, whhs, gates, seeds, _, *saved = args
    ref = mfnt_k.mfn_train_bwd_plain(_double(xps), _double(whhs),
                                     _double(gates), seeds, ps,
                                     *_double(saved))
    plain = mfnt_k.mfn_train_bwd_plain(*args)
    flat = lambda o: list(o[0]) + list(o[1]) + list(o[2])
    with torch.no_grad():
        kern = mfnt_k.mfn_train_bwd(*args)
        identical = None
        if repeat:
            identical = all(torch.equal(a, b) for a, b in
                            zip(flat(kern), flat(mfnt_k.mfn_train_bwd(*args))))
    torch.cuda.synchronize()
    names = ([f"d_xp[{m}]" for m in mods] + [f"d_whh[{m}]" for m in mods]
             + [f"d_gate[{i}]" for i in range(16)])
    valids = [None] * len(names)
    return KernelCheck(
        "mfn_train_bwd",
        _label(p) + f"B={B} T={T} {'+'.join(MOD_LETTER[m] for m in mods)}",
        _dtype_name(dtype),
        _parts(names, flat(kern), flat(plain), flat(ref), valids),
        _finite(flat(kern), valids),
        time_ms(lambda: mfnt_k.mfn_train_bwd(*args), reps, burst=KERNEL_BURST),
        time_ms(lambda: mfnt_k.mfn_train_bwd_plain(*args), min(reps, 1),
                warmup=0),
        # each step's forward recomputed from the saved states, and the two
        # products of the backward per forward product
        *bound_times({"fp32": 3 * B * T * mfn_step_ops(whhs, gates)},
                     [*xps, *whhs, *gates, *saved, *flat(kern)]),
        identical=identical)


# kernel 7's stages by the names of their CUDA kernels (csrc/mfn_train.cu),
# in the order a name is matched: the two scans, S2's row kernel and GEMMs
# (their epilogue is mfnt::Grad), S4's products and sums, the weights'
# transposes, and the rest of the namespace (S0's row kernels and GEMMs)
MFN_TRAIN_BWD_STAGES = (("S1 memory scan", "mem_bwd_kernel"),
                        ("S3 LSTM scan", "lstm_bwd_kernel"),
                        ("S2 rest of the VJP", "attend_bwd_kernel"),
                        ("S2 rest of the VJP", "mfnt::Grad"),
                        ("S4 parameter gradients", "wgrad_"),
                        ("transposes", "transpose_kernel"),
                        ("S0 recompute", "mfnt::"))


def mfn_train_bwd_stage_ms(B: int, T: int, dtype: torch.dtype, *, device,
                           seed: int = 0, mods=AVL, calls: int = 5
                           ) -> Dict[str, float]:
    """Device ms per call of each of kernel 7's stages over `calls` warm
    calls at the model's gamma dropout."""
    args = _mfn_train_bwd_case(B, T, dtype, device, seed, mods, MFN_PS)
    with torch.no_grad():
        out = kernel_device_ms(
            lambda: mfnt_k.mfn_train_bwd(*args), calls,
            lambda n: next((stage for stage, key in MFN_TRAIN_BWD_STAGES
                            if key in n), None))
    return {stage: out.get(stage, 0.0)
            for stage in sorted({stage for stage, _ in MFN_TRAIN_BWD_STAGES})}


def _window_embed_case(B, W, Fr, D, E, dtype, device, seed):
    """Front-end weights with PyTorch's default init bounds and [B, W, Fr, D]
    windows, every tensor in dtype on device."""
    gen = torch.Generator().manual_seed(seed)

    def u(bound, *shape):
        return ((torch.rand(*shape, generator=gen) * 2 - 1) * bound).to(
            device=device, dtype=dtype)

    params = [u((2 * D) ** -0.5, E, D, 2), u((2 * D) ** -0.5, E)]
    params += [u(E ** -0.5, E, E), u(E ** -0.5, E), u(E ** -0.5, E, E),
               u(E ** -0.5, E)]
    x = torch.randn(B, W, Fr, D, generator=gen).to(device=device, dtype=dtype)
    return x, params


def window_embed_ops(N: int, Fr: int, D: int, E: int, dtype) -> Dict[str, float]:
    """The conv's pair products in x's dtype, the two highway products in
    float32 (the rounding points keep the pooled rows in float32)."""
    ops = {"fp32": 4.0 * N * E * E}
    conv = _ops_type(dtype)
    ops[conv] = ops.get(conv, 0.0) + 2.0 * N * (Fr - 1) * 2 * D * E
    return ops


@torch.no_grad()
def check_window_embed(B: int, W: int, Fr: int, D: int, E: int,
                       dtype: torch.dtype, *, device, seed: int = 0,
                       reps: int = 7, repeat: bool = False) -> KernelCheck:
    """Kernel 10 on [B, W, Fr, D] windows into E channels; repeat: also
    call the kernel again and require the same bits."""
    x, params = _window_embed_case(B, W, Fr, D, E, dtype, device, seed)
    ref = we_k.window_embed_highway_plain(x.double(), *_double(params))
    plain = we_k.window_embed_highway_plain(x, *params)
    kern = we_k.window_embed_highway(x, *params)
    identical = None
    if repeat:
        identical = torch.equal(kern, we_k.window_embed_highway(x, *params))
    torch.cuda.synchronize()
    return KernelCheck(
        "window_embed_highway", f"B={B} T={W} F={Fr} D={D} E={E}",
        _dtype_name(dtype), _parts(["out"], [kern], [plain], [ref], [None]),
        _finite([kern], [None]),
        time_ms(lambda: we_k.window_embed_highway(x, *params), reps,
                burst=KERNEL_BURST),
        time_ms(lambda: we_k.window_embed_highway_plain(x, *params), reps),
        *bound_times(window_embed_ops(B * W, Fr, D, E, dtype),
                     [x, *params, kern]), identical=identical)


@torch.no_grad()
def window_embed_kernel_ms(B: int, W: int, Fr: int, D: int, E: int,
                           dtype: torch.dtype, *, device, seed: int = 0,
                           calls: int = 5) -> Dict[str, float]:
    """Device ms of kernel 10 on [B, W, Fr, D] windows from torch.profiler
    over `calls` warm calls: per launch of its CUDA kernel (by name,
    template arguments included), and per call of the copies its wrapper
    launches beside it (the weight's layout, "layout").  The card's time,
    which a host slower than the card does not move."""
    x, params = _window_embed_case(B, W, Fr, D, E, dtype, device, seed)
    seen: Dict[str, int] = {}
    out = kernel_device_ms(
        lambda: we_k.window_embed_highway(x, *params), calls,
        lambda n: (n.split("mmtx::", 1)[1].split("(", 1)[0]
                   if "mmtx::" in n else "layout"), seen=seen)
    return {k: v * calls / seen[k] if k != "layout" else v
            for k, v in sorted(out.items(), key=lambda kv: -kv[1])}


WE_GRAD_NAMES = ("x", "conv.w", "conv.b", "proj.w", "proj.b", "gate.w",
                 "gate.b")


def check_window_embed_grad(B: int, W: int, Fr: int, D: int, E: int,
                            dtype: torch.dtype, *, device,
                            seed: int = 0) -> KernelCheck:
    """`WindowEmbedHighway` (kernel forward, plain VJP backward): its output
    and the gradients of x and the six parameters under a random cotangent,
    against autograd through the plain front end (conv1d_window_embed +
    highway) in float64 and in dtype."""
    x, params = _window_embed_case(B, W, Fr, D, E, dtype, device, seed)
    gen = torch.Generator().manual_seed(seed + 1)
    g = torch.randn(B, W, E, generator=gen).to(device=device, dtype=dtype)

    def run(fn, ts):
        leaves = [t.detach().clone().requires_grad_() for t in ts]
        y = fn(*leaves)
        return [y.detach(), *torch.autograd.grad(y, leaves, g.to(y.dtype))]

    def plain_fn(*ts):
        return highway_fn(conv1d_window_embed(*ts[:3]), *ts[3:])

    ref = run(plain_fn, [x.double(), *_double(params)])
    plain = run(plain_fn, [x, *params])
    kern = run(we_k.WindowEmbedHighway.apply, [x, *params])
    torch.cuda.synchronize()
    names = ("out",) + WE_GRAD_NAMES
    valids = [None] * len(names)
    return KernelCheck(
        "WindowEmbedHighway grad", f"B={B} T={W} F={Fr} D={D} E={E}",
        _dtype_name(dtype), _parts(names, kern, plain, ref, valids),
        _finite(kern, valids), math.nan, math.nan)


def _flash_case(B, h, T, d_k, dtype, device, seed, all_masked):
    """q, k, v [B*h, T, d_k] in dtype and a key mask [B, T] of varied
    lengths (lengths_for; the first `all_masked` videos have no key)."""
    gen = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(B * h, T, d_k, generator=gen).to(device=device,
                                                            dtype=dtype)
               for _ in range(3))
    lens = torch.as_tensor(lengths_for(B, T, seed))
    lens[:all_masked] = 0
    kmask = (torch.arange(T)[None, :] < lens[:, None]).float().to(device)
    return q, k, v, kmask


def flash_ops(BH: int, Tq: int, Tk: int, d_k: int) -> float:
    """The scores and p @ v over every key."""
    return 4.0 * BH * Tq * Tk * d_k


@torch.no_grad()
def check_flash_attention(B: int, h: int, T: int, d_k: int,
                          dtype: torch.dtype, *, device, seed: int = 0,
                          all_masked: int = 0, reps: int = 7) -> KernelCheck:
    """Kernel 11 on [B*h, T, d_k] heads with a [B, T] key mask, every query
    row compared (query rows are not masked).  library_ms: PyTorch's
    scaled_dot_product_attention with the same boolean key mask, timed as a
    yardstick (it gives NaN on a row whose keys are all masked, so it is
    only timed)."""
    q, k, v, kmask = _flash_case(B, h, T, d_k, dtype, device, seed,
                                 all_masked)
    ref = fa_k.flash_attention_masked_plain(q.double(), k.double(),
                                            v.double(), kmask, h)
    plain = fa_k.flash_attention_masked_plain(q, k, v, kmask, h)
    kern = fa_k.flash_attention_masked(q, k, v, kmask, h)
    torch.cuda.synchronize()
    heads = lambda t: t.view(B, h, T, d_k)
    attend = kmask.bool()[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    c = KernelCheck(
        "flash_attention_masked", f"B={B} h={h} T={T} dk={d_k}",
        _dtype_name(dtype), _parts(["out"], [kern], [plain], [ref], [None]),
        _finite([kern], [None]),
        time_ms(lambda: fa_k.flash_attention_masked(q, k, v, kmask, h), reps,
                burst=KERNEL_BURST),
        time_ms(lambda: fa_k.flash_attention_masked_plain(q, k, v, kmask, h),
                reps),
        *bound_times({_ops_type(dtype): flash_ops(B * h, T, T, d_k)},
                     [q, k, v, kmask, kern]))
    c.library_ms = time_ms(lambda: sdpa(heads(q), heads(k), heads(v),
                                        attn_mask=attend), reps,
                           burst=KERNEL_BURST)
    return c


FA_GRAD_NAMES = ("q", "k", "v")


def check_flash_attention_grad(B: int, h: int, T: int, d_k: int,
                               dtype: torch.dtype, *, device, seed: int = 0,
                               all_masked: int = 1) -> KernelCheck:
    """`FlashAttention` (kernel forward, plain VJP backward): its output and
    the gradients of q, k and v under a random cotangent, against autograd
    through the plain version in float64 and in dtype."""
    q, k, v, kmask = _flash_case(B, h, T, d_k, dtype, device, seed,
                                 all_masked)
    gen = torch.Generator().manual_seed(seed + 1)
    g = torch.randn(B * h, T, d_k, generator=gen).to(device=device,
                                                     dtype=dtype)

    def run(fn, ts):
        leaves = [t.detach().clone().requires_grad_() for t in ts]
        y = fn(*leaves, kmask, h)
        return [y.detach(), *torch.autograd.grad(y, leaves, g.to(y.dtype))]

    ref = run(fa_k.flash_attention_masked_plain, _double([q, k, v]))
    plain = run(fa_k.flash_attention_masked_plain, [q, k, v])
    kern = run(fa_k.FlashAttention.apply, [q, k, v])
    torch.cuda.synchronize()
    names = ("out",) + FA_GRAD_NAMES
    valids = [None] * len(names)
    return KernelCheck(
        "FlashAttention grad", f"B={B} h={h} T={T} dk={d_k}",
        _dtype_name(dtype), _parts(names, kern, plain, ref, valids),
        _finite(kern, valids), math.nan, math.nan)
