"""Time one of the redesigned kernels of a checkout on the card.

For comparing two versions of a kernel in one session: run it once per
checkout, alternating (A, B, B, A), from any directory.  `--tree` names the
checkout whose package is imported (default: the one holding this file); a
checkout older than this script works too, since only its
`ops/cuda/verify.py` helpers and its wrappers are used.  The kernel is one
of:

- `a`: kernel A (`ops/cuda/encoder.py:encoder_stack_fused`) at the serving
  batch, B=32 at T in {160, 137, 544}, and one video (per-video
  evaluation), B=1 at T in {37, 512}; D=256, h=8, F=128, 6 layers, varied
  lengths in a batch (one whole video at B=1); then the device ms of each
  CUDA kernel name it launches at B=32, T=160;
- `b`: kernel B (`ops/cuda/mfn.py:mfn_scan_fused`) at the shapes
  chip_smoke.py checks it at, plus B=32, T=1,120; where the checkout's
  verify.py has `mfn_stage_ms`, the device time of each stage at B=32,
  T=160 follows;
- `variants`: kernel B and rows 8 and 9 (`ops/cuda/mfn_variants.py:
  mfn_scan_packed` and `mfn_scan_aligned`, the latter also at hp = 128
  where the checkout's wrapper takes hp) at B=32, T=160, A+V+L: each
  call's card ms in bursts (the wrapper's packing in torch included) and
  the host's ms to enqueue one, the device ms of each CUDA kernel name it
  launches and their sum (torch.profiler, events captured over 5 calls),
  and, where the checkout's `mfn_stage_ms` takes a scan, each stage's;
- `fwd`: kernel 3 (`ops/cuda/encoder_train.py:encoder_stack_train_fwd`, the
  encoder's training forward) at B=32, T in {160, 137, 400}; D=256, h=8,
  F=128, p=0.1, 6 layers; then the device ms of each CUDA kernel name it
  launches at B=32, T=160 (torch.profiler, events captured over 5 calls);
- `bwd`: kernels 4 and 5 (`ops/cuda/encoder_train.py:encoder_layer_bwd` and
  `encoder_stack_bwd`, the encoder's training backward) at B=32, T in {160,
  137, 400} (the training batch, a ragged one, and the longest the training
  phase sends); D=256, h=8, F=128, p=0.1, kernel 4 on one layer, kernel 5
  on a stack of 6 from kernel 3's saved inputs;
  `fwd` and `bwd` take `--stream hash4`: the same calls on the "hash4"
  dropout stream (the checkout's wrappers must take `hash4`);
- `mfn_fwd`: kernel 6 (`ops/cuda/mfn_train.py:mfn_train_fwd`, the MFN's
  training forward) at B=32, T in {160, 400} (A+V+L) and B=4, T=9 (L
  alone), at the model's gamma dropout; at B=32, T=160 also the host's ms
  to enqueue one call behind ~20 ms of queued card work (a call that
  synchronises with the card waits it out), and the device ms of each CUDA
  kernel name it launches (torch.profiler, events captured over 5 calls);
  then, where the checkout's verify.py has `mfn_train_fwd_stage_ms`, the
  device ms of each stage;
- `mfn_bwd`: kernel 7 (`ops/cuda/mfn_train.py:mfn_train_bwd`, the MFN's
  reverse recurrence) at B=32, T in {160, 400} (A+V+L) and B=4, T=9 (L
  alone), from kernel 6's saved states and random cotangents at the
  model's gamma dropout; then the device ms of each CUDA kernel name it
  launches at B=32, T=160 (torch.profiler, events captured over 5 calls),
  and, where the checkout's verify.py has `mfn_train_bwd_stage_ms`, the
  device ms of each stage;
- `wembed`: kernel 10 (`ops/cuda/window_embed.py:window_embed_highway`,
  the front end's window embed) at chip_smoke.py's five shapes: B=32,
  T=160 at (F, D, E) = (4, 88, 88), (4, 88, 256), (4, 1000, 256) and (32,
  300, 300), and the ragged (3, 7, 200, 33, 45); each with the device ms
  per launch of its CUDA kernel and the device-busy ms of a call
  (torch.profiler over 5 calls), which the host's speed does not move;
- `serve`: the bf16 serving forward of MFT A+V+L at B=32, T=160 (the
  forward chip_smoke.py's slice phase times: `ValencePredictor`'s module
  from seeded random weights), timed alone between two events as the slice
  phase times it (the host's enqueue included) and in bursts of 5, then
  its device-busy ms a call (torch.profiler over 5 calls), which the
  host's speed does not move;
- `step`: the bf16 mixed train step (forward, backward, Adam) of MFT A+V+L,
  B3-MFN A+V+L and B2-Trans A+V+L (the step that follows the card and
  runs kernel 3 once) at B=32, T=160 (lengths T - (i % 5), chip_smoke.py's
  frames per window), from a batch on the card, the whole model at full
  width from seeded random weights (`engine.Engine.train_step`); then its
  device-busy ms a step, as for `serve`.

`outputs` times nothing: it saves kernel A's bf16 output at B=32, T in {160,
544} (D=256) and B=1, T=37 (D=128), kernel 3's bf16 outputs (out and
saved) at B=32, T=160, D=256, p=0.1; T=137, D=128, p=0.1; T=400, D=256,
p=0, kernel B's outputs (hs and mems), bf16 and fp32, at the shapes `b`
times but B=32, T=1,120, and kernels 6's (hs, cs, mems) and 7's (every
gradient, from seeded cotangents), bf16 and fp32, at the model's gamma
dropout and at p = 0, at the shapes chip_smoke.py checks them at, to
`--save FILE`; `outputs --compare A B` says, for each, whether two
such files hold the same bits.  Run it once per checkout, each in its own
process (two builds of the library do not mix in one process).

Seeded random weights and inputs, bf16 then fp32 (`serve`, `step`,
`outputs`: bf16 only).  Each
line is the median of 7 bursts of 5 calls (CUDA events; `step`: of 25 steps,
with their least and most: the host sets the step's time, and it drifts);
for `a`, `fwd`, `bwd`, `mfn_fwd`, `mfn_bwd` and `wembed` the host's time to enqueue one call
follows (the wrapper and its launches, the card idle
before it; median of 7, perf_counter).

    python multimodal_transformer_tpu_torch/bench_kernels.py {a,b,variants,fwd,bwd,mfn_fwd,mfn_bwd,wembed,serve,step} [--tree DIR]
    python multimodal_transformer_tpu_torch/bench_kernels.py {fwd,bwd} --stream hash4 [--tree DIR]
    python multimodal_transformer_tpu_torch/bench_kernels.py outputs [--tree DIR] --save FILE
    python multimodal_transformer_tpu_torch/bench_kernels.py outputs --compare FILE FILE
"""

from __future__ import annotations

import argparse
import functools
import inspect
import os
import statistics
import sys
import time

A_SHAPES = ((32, 160), (32, 137), (32, 544), (1, 37), (1, 512))
AVL = ("acoustic", "image", "linguistic")
B_SHAPES = ((32, 160, AVL), (3, 7, ("linguistic", "acoustic")),
            (4, 9, ("emotient", "acoustic")), (2, 1120, AVL), (1, 37, AVL),
            (32, 1120, AVL))
BWD_SHAPES = ((32, 160), (32, 137), (32, 400))
MFN_BWD_SHAPES = ((32, 160, AVL), (32, 400, AVL), (4, 9, ("linguistic",)))
# kernels 6 and 7's shapes in chip_smoke.py's train-kernels phase
MFN_TRAIN_SHAPES = MFN_BWD_SHAPES + ((3, 7, ("emotient", "acoustic")),
                                     (1, 37, AVL), (2, 1120, AVL))
STEP_FAMILIES = ("MFT", "B3-MFN", "B2-Trans")
WEMBED_SHAPES = ((32, 160, 4, 88, 88), (32, 160, 4, 88, 256),
                 (32, 160, 4, 1000, 256), (32, 160, 32, 300, 300),
                 (3, 7, 200, 33, 45))
FRAMES = {"acoustic": 4, "image": 4, "linguistic": 32}
P, H, LAYERS = 0.1, 8, 6


def timed(torch, verify, call, host: bool = True) -> str:
    """The call's card ms (median of 7 bursts of 5) and, with host, the
    host's median ms to enqueue one call after the card went idle."""
    ms = verify.time_ms(call, reps=7, burst=5)
    if not host:
        return f"{ms:.4f} ms"
    times = []
    for _ in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return f"{ms:.4f} ms, host {statistics.median(times):.4f} ms"


def bench_a(torch, verify, dev, dtype, dname):
    from multimodal_transformer_tpu_torch.ops.cuda import encoder

    enc = verify.random_encoder(torch.Generator().manual_seed(0)).to(
        device=dev, dtype=dtype)
    for B, T in A_SHAPES:
        gen = torch.Generator().manual_seed(B * T)
        x = torch.randn(B, T, 256, generator=gen).to(device=dev, dtype=dtype)
        mask = (verify._key_mask(B, T, 0, dtype, dev) if B > 1 else
                torch.ones(B, T, 1, device=dev, dtype=dtype))
        with torch.no_grad():
            call = functools.partial(encoder.encoder_stack_fused, enc, x, mask)
            yield f"kernel A B={B} T={T} {dname} {timed(torch, verify, call)}"
            if (B, T) == (32, 160):
                yield _device_ms(verify, call, dname)


def bench_b(torch, verify, dev, dtype, dname):
    from multimodal_transformer_tpu_torch.ops.cuda import mfn

    for B, T, mods in B_SHAPES:
        _, xps, whhs, gates = verify._mfn_case(B, T, dtype, dev, 0, mods)
        with torch.no_grad():
            call = functools.partial(mfn.mfn_scan_fused, xps, whhs, gates)
            yield (f"kernel B B={B} T={T} {'+'.join(m[0] for m in mods)} "
                   f"{dname} {timed(torch, verify, call, host=False)}")
    if hasattr(verify, "mfn_stage_ms"):
        stages = verify.mfn_stage_ms(32, 160, dtype, device=dev)
        yield f"stages {dname} " + ", ".join(f"{k} {v:.4f}"
                                            for k, v in stages.items())


def bench_variants(torch, verify, dev, dtype, dname):
    from multimodal_transformer_tpu_torch.ops.cuda import mfn, mfn_variants

    _, xps, whhs, gates = verify._mfn_case(32, 160, dtype, dev, 0, AVL)
    scans = {"kernel B": mfn.mfn_scan_fused,
             "row 8 packed": mfn_variants.mfn_scan_packed,
             "row 9 aligned": mfn_variants.mfn_scan_aligned}
    if "hp" in inspect.signature(mfn_variants.mfn_scan_aligned).parameters:
        scans["row 9 aligned hp=128"] = functools.partial(
            mfn_variants.mfn_scan_aligned, hp=128)
    staged = "scan" in inspect.signature(verify.mfn_stage_ms).parameters
    for name, scan in scans.items():
        with torch.no_grad():
            call = functools.partial(scan, xps, whhs, gates)
            yield f"{name} B=32 T=160 {dname} {timed(torch, verify, call)}"
            yield f"{name} " + _device_ms(verify, call, dname)
        if staged:
            stages = verify.mfn_stage_ms(32, 160, dtype, device=dev, scan=scan)
            yield f"{name} stages {dname} " + ", ".join(
                f"{k} {v:.4f}" for k, v in stages.items())


def bench_fwd(torch, verify, dev, dtype, dname, hash4: bool = False):
    from multimodal_transformer_tpu_torch.ops.cuda import encoder_train as et

    stream = (True,) if hash4 else ()  # older checkouts take no hash4
    for B, T in BWD_SHAPES:
        _, params, x, kmask, seeds = verify._encoder_train_case(
            B, T, dtype, dev, 0, 256, 128, LAYERS)
        with torch.no_grad():
            call = functools.partial(et.encoder_stack_train_fwd, params, x,
                                     kmask, seeds, P, H, *stream)
            yield f"kernel 3 B={B} T={T} {dname} {timed(torch, verify, call)}"
            if (B, T) == (32, 160):
                yield _device_ms(verify, call, dname)


def bench_bwd(torch, verify, dev, dtype, dname, hash4: bool = False):
    from multimodal_transformer_tpu_torch.ops.cuda import encoder_train as et

    stream = (True,) if hash4 else ()
    for B, T in BWD_SHAPES:
        gen, params, x, kmask, seeds = verify._encoder_train_case(
            B, T, dtype, dev, 0, 256, 128, LAYERS)
        with torch.no_grad():
            _, saved = et.encoder_stack_train_fwd(params, x, kmask, seeds, P,
                                                  H, *stream)
            dy = torch.randn(B, T, 256, generator=gen).to(dev) \
                * kmask[..., None]
            calls = {
                "kernel 4": functools.partial(
                    et.encoder_layer_bwd, params[:16], saved[0], dy, kmask,
                    seeds[0], P, H, *stream),
                "kernel 5": functools.partial(
                    et.encoder_stack_bwd, params, saved, dy, kmask, seeds, P,
                    H, *stream)}
            for what, call in calls.items():
                yield (f"{what} B={B} T={T} {dname} "
                       f"{timed(torch, verify, call)}")


def queued_host_ms(torch, call, busy_ms: float = 20.0) -> str:
    """The host's median ms to enqueue one call while the card still has
    ~busy_ms of work queued (torch.cuda._sleep, clocked by the card's SM
    clock): a call that waits for the card takes at least what is left."""
    clock_khz = torch.cuda.get_device_properties(0).clock_rate
    times = []
    for _ in range(7):
        torch.cuda.synchronize()
        torch.cuda._sleep(int(busy_ms * clock_khz))
        t0 = time.perf_counter()
        call()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return (f"host {statistics.median(times):.4f} ms behind {busy_ms:.0f} ms "
            "of queued card work")


def _kernel_name(name: str):
    """A CUDA kernel's name in the port's namespace, without its namespaces,
    template arguments and parameters; None for any other event."""
    if "mmtx::" not in name:
        return None
    return name.split("(", 1)[0].split("<", 1)[0].rsplit("::", 1)[-1]


def _device_ms(verify, call, dname) -> str:
    """The device ms per call of each CUDA kernel name of call
    (torch.profiler, events captured over 5 calls)."""
    seen = {}
    ms = verify.kernel_device_ms(call, 5, _kernel_name, seen=seen)
    return (f"kernels {dname}, device ms per call (events captured): "
            + ", ".join(f"{k} {v:.4f} ({seen[k]})" for k, v in
                        sorted(ms.items(), key=lambda kv: -kv[1]))
            + f"; in all {sum(ms.values()):.4f}")


def _busy_ms(torch, call, calls: int = 5) -> str:
    """The device-busy ms per call of call: the union of the intervals in
    which one of its kernels or copies ran (torch.profiler over `calls`
    calls after a warm one; user annotations left out), which the host's
    speed does not move, and the device events captured per call.  The
    window is padded (engine.profiling.pad_window) so that it loses none of
    the calls' records; the pad's kernels are left out."""
    from torch.profiler import ProfilerActivity, profile

    from multimodal_transformer_tpu_torch.engine.profiling import (
        PAD_KERNEL_MARK, pad_window)

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        pad_window(start=True)
        for _ in range(calls):
            call()
        pad_window(start=False)
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if str(e.device_type).endswith("CUDA")
                   and not getattr(e, "is_user_annotation", False)
                   and PAD_KERNEL_MARK not in e.name)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return (f"device busy {busy / 1e3 / calls:.4f} ms a call "
            f"({len(spans) / calls:.1f} events a call)")


def bench_mfn_fwd(torch, verify, dev, dtype, dname):
    from multimodal_transformer_tpu_torch.ops.cuda import mfn_train as mt

    for B, T, mods in MFN_BWD_SHAPES:
        _, xps, whhs, gates, seeds = verify._mfn_train_case(B, T, dtype, dev,
                                                            0, mods)
        with torch.no_grad():
            call = functools.partial(mt.mfn_train_fwd, xps, whhs, gates,
                                     seeds, verify.MFN_PS)
            yield (f"kernel 6 B={B} T={T} {'+'.join(m[0] for m in mods)} "
                   f"{dname} {timed(torch, verify, call)}")
            if (B, T) == (32, 160):
                yield f"kernel 6 {dname} {queued_host_ms(torch, call)}"
                yield _device_ms(verify, call, dname)
    if hasattr(verify, "mfn_train_fwd_stage_ms"):
        stages = verify.mfn_train_fwd_stage_ms(32, 160, dtype, device=dev)
        yield f"stages {dname} " + ", ".join(f"{k} {v:.4f}"
                                            for k, v in stages.items())


def bench_mfn_bwd(torch, verify, dev, dtype, dname):
    from multimodal_transformer_tpu_torch.ops.cuda import mfn_train as mt

    ps = verify.MFN_PS
    for B, T, mods in MFN_BWD_SHAPES:
        gen, xps, whhs, gates, seeds = verify._mfn_train_case(B, T, dtype, dev,
                                                              0, mods)
        with torch.no_grad():
            hs, cs, mems = mt.mfn_train_fwd(xps, whhs, gates, seeds, ps)
            g_hs = torch.randn(hs.shape, generator=gen).to(dev)
            g_mems = torch.randn(mems.shape, generator=gen).to(dev)
            call = functools.partial(mt.mfn_train_bwd, xps, whhs, gates, seeds,
                                     ps, hs, cs, mems, g_hs, g_mems)
            yield (f"kernel 7 B={B} T={T} {'+'.join(m[0] for m in mods)} "
                   f"{dname} {timed(torch, verify, call)}")
            if (B, T) != (32, 160):
                continue
            yield _device_ms(verify, call, dname)
    if hasattr(verify, "mfn_train_bwd_stage_ms"):
        stages = verify.mfn_train_bwd_stage_ms(32, 160, dtype, device=dev)
        yield f"stages {dname} " + ", ".join(f"{k} {v:.4f}"
                                            for k, v in stages.items())


def bench_wembed(torch, verify, dev, dtype, dname):
    from multimodal_transformer_tpu_torch.ops.cuda import window_embed as we

    for B, T, Fr, D, E in WEMBED_SHAPES:
        x, params = verify._window_embed_case(B, T, Fr, D, E, dtype, dev, 0)
        with torch.no_grad():
            call = functools.partial(we.window_embed_highway, x, *params)
            seen = {}
            ms = verify.kernel_device_ms(call, 5, _kernel_name, seen=seen)
            device = ", ".join(f"{k} {v * 5 / seen[k]:.4f}"
                               for k, v in ms.items())
            yield (f"kernel 10 B={B} T={T} F={Fr} D={D} E={E} {dname} "
                   f"{timed(torch, verify, call)}; device ms a launch: "
                   f"{device}; {_busy_ms(torch, call)}")


def bench_serve(torch, verify, dev, dtype, dname):
    if dtype != torch.bfloat16:
        return
    from multimodal_transformer_tpu_torch import (ValencePredictor, build_model,
                                                  default_config)

    cfg = default_config("MFT", AVL, mask_mode="key_query")
    module = build_model(cfg, seed=0, device=dev)
    predictor = ValencePredictor(cfg, module, device=dev, bf16=True)
    gen = torch.Generator().manual_seed(1)
    inputs = {m: torch.randn(32, 160, FRAMES[m], cfg.mod_dimension[m],
                             generator=gen).to(device=dev, dtype=dtype)
              for m in AVL}
    mask = torch.ones(32, 160, 1, device=dev, dtype=dtype)
    fwd = lambda: predictor.module(inputs, mask, mask_mode="key_query")
    with torch.inference_mode():
        alone = verify.time_ms(fwd, reps=9)
        burst = verify.time_ms(fwd, reps=7, burst=5)
        busy = _busy_ms(torch, fwd)
    yield (f"serving forward MFT A+V+L B=32 T=160 {dname}: {alone:.3f} ms a "
           f"call alone, {burst:.3f} ms a call in bursts of 5, {busy}")


def bench_step(torch, verify, dev, dtype, dname):
    if dtype != torch.bfloat16:
        return
    import numpy as np

    from multimodal_transformer_tpu_torch import default_config
    from multimodal_transformer_tpu_torch.data import Batch
    from multimodal_transformer_tpu_torch.engine import Engine

    B, T = 32, 160
    lens = [T - (i % 5) for i in range(B)]
    mask = (np.arange(T)[None, :, None] < np.array(lens)[:, None, None])
    for family in STEP_FAMILIES:
        cfg = default_config(family, AVL, mask_mode="key_query")
        rs = np.random.RandomState(3)
        batch = Batch(
            {m: torch.from_numpy(rs.randn(B, T, FRAMES[m], cfg.mod_dimension[m])
                                 .astype(np.float32)).to(dev, dtype)
             for m in AVL},
            torch.from_numpy(rs.randn(B, T, 1).astype(np.float32)).to(dev),
            torch.from_numpy(mask.astype(np.float32)).to(dev, dtype), lens)
        engine = Engine(cfg, seed=1, train_dtype=dtype, device=dev)
        ms = verify.runs_ms(lambda: engine.train_step(batch), reps=25)
        busy = _busy_ms(torch, lambda: engine.train_step(batch))
        yield (f"train step {family} A+V+L B={B} T={T} {dname} mixed, card "
               f"batch: {statistics.median(ms):.3f} ms/step (least "
               f"{min(ms):.3f}, most {max(ms):.3f}), {busy}")


def outputs(torch, verify, dev) -> dict:
    """Kernel A's, kernel 3's, kernel B's and kernels 6 and 7's outputs at
    fixed shapes, on the host."""
    from multimodal_transformer_tpu_torch.ops.cuda import encoder
    from multimodal_transformer_tpu_torch.ops.cuda import encoder_train as et
    from multimodal_transformer_tpu_torch.ops.cuda import mfn
    from multimodal_transformer_tpu_torch.ops.cuda import mfn_train as mt

    bf16, out = torch.bfloat16, {}
    with torch.no_grad():
        for B, T, D in ((32, 160, 256), (32, 544, 256), (1, 37, 128)):
            enc, x, mask = verify._encoder_case(B, T, bf16, dev, 0, D, 128,
                                                LAYERS)
            out[f"kernel A B={B} T={T} D={D}"] = (
                encoder.encoder_stack_fused(enc, x, mask).cpu(),)
        for T, D, p in ((160, 256, P), (137, 128, P), (400, 256, 0.0)):
            _, params, x, kmask, seeds = verify._encoder_train_case(
                32, T, bf16, dev, 0, D, 128, LAYERS)
            o, saved = et.encoder_stack_train_fwd(params, x, kmask, seeds, p, H)
            out[f"kernel 3 B=32 T={T} D={D} p={p}"] = (o.cpu(), saved.cpu())
        for dtype in (bf16, torch.float32):
            for B, T, mods in B_SHAPES[:-1]:
                _, xps, whhs, gates = verify._mfn_case(B, T, dtype, dev, 0,
                                                       mods)
                out[f"kernel B B={B} T={T} {'+'.join(m[0] for m in mods)} "
                    f"{dtype}"] = tuple(
                        t.cpu() for t in mfn.mfn_scan_fused(xps, whhs, gates))
            for (B, T, mods), ps in ((s, p) for s in MFN_TRAIN_SHAPES
                                     for p in (verify.MFN_PS, (0.0, 0.0))):
                gen, xps, whhs, gates, seeds = verify._mfn_train_case(
                    B, T, dtype, dev, 0, mods)
                key = (f"B={B} T={T} {'+'.join(m[0] for m in mods)} "
                       f"p={ps[0]} {dtype}")
                hs, cs, mems = mt.mfn_train_fwd(xps, whhs, gates, seeds, ps)
                out[f"kernel 6 {key}"] = (hs.cpu(), cs.cpu(), mems.cpu())
                g_hs = torch.randn(hs.shape, generator=gen).to(dev)
                g_mems = torch.randn(mems.shape, generator=gen).to(dev)
                grads = mt.mfn_train_bwd(xps, whhs, gates, seeds, ps, hs, cs,
                                         mems, g_hs, g_mems)
                out[f"kernel 7 {key}"] = tuple(t.cpu() for ts in grads
                                               for t in ts)
    return out


BENCHES = {"a": bench_a, "b": bench_b, "variants": bench_variants,
           "fwd": bench_fwd, "bwd": bench_bwd,
           "mfn_fwd": bench_mfn_fwd, "mfn_bwd": bench_mfn_bwd,
           "wembed": bench_wembed,
           "serve": bench_serve, "step": bench_step}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("kernel", choices=sorted(BENCHES) + ["outputs"])
    ap.add_argument("--tree", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--save", help="outputs: the file to save them to")
    ap.add_argument("--compare", nargs=2, metavar="FILE",
                    help="outputs: compare two saved files")
    ap.add_argument("--stream", choices=("hash", "hash4"), default="hash",
                    help="fwd, bwd: the dropout stream")
    args = ap.parse_args()
    if (args.kernel == "outputs") != bool(args.save or args.compare):
        ap.error("outputs takes --save or --compare, and only it does")
    if args.stream == "hash4" and args.kernel not in ("fwd", "bwd"):
        ap.error("--stream hash4 is for fwd and bwd")
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    if args.compare:
        a, b = (torch.load(f) for f in args.compare)
        for k in a:
            same = all(torch.equal(x, y) for x, y in zip(a[k], b[k]))
            print(f"{k}: bit-identical: {same}", flush=True)
        return 0

    from multimodal_transformer_tpu_torch.ops.cuda import verify

    if not torch.cuda.is_available():
        print("no CUDA device: the kernels run only on the card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name = os.path.basename(tree)
    if args.kernel == "outputs":
        torch.save(outputs(torch, verify, dev), args.save)
        print(f"[{name}] outputs saved to {args.save}", flush=True)
        return 0
    bench = BENCHES[args.kernel]
    if args.stream == "hash4":
        bench = functools.partial(bench, hash4=True)
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        if args.stream == "hash4":
            dname += " hash4"
        for line in bench(torch, verify, dev, dtype, dname):
            print(f"[{name}] {line}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
