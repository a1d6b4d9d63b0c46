#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it.

Run from the repository root: `python3 chip_smoke.py`.  Six phases, any
failure exits nonzero:

1. gate: a CUDA device must be present (there is no CPU path); prints the
   card's name and power limit as nvidia-smi reports them;
2. build: compiles the CUDA kernels from multimodal_transformer_tpu_torch/csrc;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main path's shapes, fp32 and bf16, within the competitive bound
   err(kernel - fp64 plain) <= 2 * err(plain - fp64 plain) + 1e-6;
4. slice: ValencePredictor at full MFT A+V+L widths (random weights from a
   seed) answers 3 requests of 20 videos; traces are checked for length,
   finiteness, determinism and against the plain fp32 forward; both kernels'
   launch counters must show the main path went through them; B=32, T=160
   bf16 forwards are timed;
5. train kernels: the four training kernels (encoder stack forward and layer
   backward, MFN forward and reverse recurrence) against their plain
   versions at B=32, T=160 and T=400, fp32 and bf16, the bound applied to
   every output tensor (dx and each gradient included);
6. train: Engine.train_epoch at full MFT A+V+L widths, bf16 mixed with fp32
   masters, dropout on, over 100 synthetic videos of 20-400 windows at
   batch size 25 (launch counters exact, every loss finite); one fp32 step
   of the kernel path against the plain path from the same parameters,
   batch and seeds (loss within 1e-4 relative, every gradient within 1e-3
   relative L2); the same step twice gives bit-identical gradients; B=32,
   T=160 mixed steps are timed on both paths and profiled.

The line before the last is a JSON object with each kernel's launches, error
and times; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import copy
import json
import logging
import math
import subprocess
import sys
import time
from pathlib import Path

AVL = ("acoustic", "image", "linguistic")
FRAMES = {"acoustic": 4, "image": 4, "linguistic": 32}
# bf16 serving against the plain fp32 forward, absolute, on valence outputs
# of magnitude ~0.06 at this random init: the all-bf16 plain path differs by
# ~1e-3 on the CPU, and the kernel path keeps more of its math in fp32.
SLICE_TOL = 3e-3
REQUESTS, VIDEOS, MIN_WINDOWS, MAX_WINDOWS = 3, 20, 20, 400
BENCH_B, BENCH_T = 32, 160
TRAIN_VIDEOS, TRAIN_BATCH = 100, 25
TRAIN_T = (160, 400)
# one fp32 step, kernel path against plain path: the masks are bit-identical,
# so only the order of float32 sums differs.  A gradient passes when
# |g_kernel - g_plain| <= GRAD_RTOL |g_plain| + GRAD_FLOOR |all grads|: the
# floor covers the k-projection biases, whose gradients are mathematically
# zero (softmax row gradients sum to zero) and so are pure rounding noise.
LOSS_RTOL, GRAD_RTOL, GRAD_FLOOR = 1e-4, 1e-3, 1e-6
SOURCES = {
    "encoder_stack_fused": ("multimodal_transformer_tpu_torch/csrc/encoder.cu",
                            "multimodal_transformer_tpu/ops/pallas/encoder.py:313"),
    "mfn_scan_fused": ("multimodal_transformer_tpu_torch/csrc/mfn.cu",
                       "multimodal_transformer_tpu/ops/pallas/mfn_kernel.py:145"),
    "encoder_stack_train_fwd": (
        "multimodal_transformer_tpu_torch/csrc/encoder_train.cu",
        "multimodal_transformer_tpu/ops/pallas/encoder.py:1179"),
    "encoder_layer_bwd": (
        "multimodal_transformer_tpu_torch/csrc/encoder_train.cu",
        "multimodal_transformer_tpu/ops/pallas/encoder.py:1284"),
    "mfn_train_fwd": ("multimodal_transformer_tpu_torch/csrc/mfn_train.cu",
                      "multimodal_transformer_tpu/ops/pallas/mfn_train.py:147"),
    "mfn_train_bwd": ("multimodal_transformer_tpu_torch/csrc/mfn_train.cu",
                      "multimodal_transformer_tpu/ops/pallas/mfn_train.py:435"),
}


class SmokeFailure(Exception):
    pass


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        raise SmokeFailure(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def n_batches(lens, batch_size: int, time_multiple: int) -> int:
    buckets: dict = {}
    for n in lens:
        b = -(-max(int(n), 1) // time_multiple)
        buckets[b] = buckets.get(b, 0) + 1
    return sum(-(-c // batch_size) for c in buckets.values())


def run_kernel_checks(torch, device):
    from multimodal_transformer_tpu_torch.ops.cuda import verify

    checks = []
    for dtype in (torch.float32, torch.bfloat16):
        for T in (160, 137, 544):
            checks.append(verify.check_encoder(32, T, dtype, device=device))
            print(checks[-1].line(), flush=True)
        checks.append(verify.check_mfn(32, 160, dtype, device=device))
        print(checks[-1].line(), flush=True)
    bad = [c for c in checks if not c.ok]
    if bad:
        raise SmokeFailure(f"{len(bad)} kernel check(s) outside the bound")
    return checks


def run_slice(torch, np, device):
    from multimodal_transformer_tpu_torch import (ValencePredictor, build_model,
                                                  default_config)
    from multimodal_transformer_tpu_torch.ops.cuda import encoder as enc_k
    from multimodal_transformer_tpu_torch.ops.cuda import mfn as mfn_k
    from multimodal_transformer_tpu_torch.ops.cuda.verify import time_ms

    cfg = default_config("MFT", AVL, mask_mode="key_query")
    module = build_model(cfg, generator=torch.Generator().manual_seed(0))
    predictor = ValencePredictor(cfg, module, device=device, bf16=True)
    print(f"model: MFT A+V+L, mod dims {[cfg.mod_dimension[m] for m in AVL]}, "
          f"window embeds {[cfg.window_embed_size[m] for m in AVL]}, frames "
          f"{[FRAMES[m] for m in AVL]}, "
          f"{sum(p.numel() for p in module.parameters())} params", flush=True)
    rng = np.random.default_rng(0)
    requests = []
    for _ in range(REQUESTS):
        lens = rng.integers(MIN_WINDOWS, MAX_WINDOWS + 1, size=VIDEOS)
        W = int(lens.max())
        data = {m: rng.standard_normal((VIDEOS, W, FRAMES[m], cfg.mod_dimension[m]),
                                       dtype=np.float32) for m in AVL}
        requests.append((data, lens))
    expected = sum(n_batches(lens, predictor.batch_size, predictor.time_multiple)
                   for _, lens in requests)

    enc_k.reset_launches()
    mfn_k.reset_launches()
    t0 = time.perf_counter()
    answers = [predictor.predict_padded(data, lens) for data, lens in requests]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    enc_launches, mfn_launches = enc_k.launches, mfn_k.launches
    print(f"served {len(requests)} requests x {VIDEOS} videos in {wall:.3f} s "
          f"(first use, {expected} batches); launches: encoder_stack_fused="
          f"{enc_launches} mfn_scan_fused={mfn_launches}", flush=True)
    if enc_launches != 3 * expected or mfn_launches != expected:
        raise SmokeFailure(f"expected {3 * expected} encoder and {expected} "
                           "MFN launches on the main path")

    for (data, lens), traces in zip(requests, answers):
        for tr, n in zip(traces, lens):
            if tr.shape != (int(n),) or not np.isfinite(tr).all():
                raise SmokeFailure(f"trace of length {tr.shape} for a "
                                   f"{n}-window video, or not finite")
    again = predictor.predict_padded(*requests[0])
    if any(not np.array_equal(a, b) for a, b in zip(answers[0], again)):
        raise SmokeFailure("two calls on the same request differ")

    ref_module = copy.deepcopy(module).to(device=device,
                                          dtype=torch.float32).eval()
    data, lens = requests[0]
    worst = 0.0
    for vi in sorted({int(np.argmin(lens)), int(np.argmax(lens)), VIDEOS // 2}):
        n = int(lens[vi])
        inputs = {m: torch.from_numpy(data[m][vi:vi + 1, :n]).to(device)
                  for m in AVL}
        mask = torch.ones(1, n, 1, device=device)
        with torch.inference_mode():
            ref = ref_module(inputs, mask, mask_mode="key_query", plain=True)
        err = float(np.abs(answers[0][vi] - ref[0, :, 0].cpu().numpy()).max())
        worst = max(worst, err)
        print(f"video {vi} (T={n}): |bf16 kernel path - fp32 plain| = "
              f"{err:.3e} (tol {SLICE_TOL:.0e})", flush=True)
    if worst > SLICE_TOL:
        raise SmokeFailure("bf16 serving path outside the tolerance")

    B, T = BENCH_B, BENCH_T
    gen = torch.Generator().manual_seed(1)
    inputs = {m: torch.randn(B, T, FRAMES[m], cfg.mod_dimension[m],
                             generator=gen).to(device=device,
                                               dtype=torch.bfloat16)
              for m in AVL}
    mask = torch.ones(B, T, 1, device=device, dtype=torch.bfloat16)
    mod = predictor.module
    with torch.inference_mode():
        ms = time_ms(lambda: mod(inputs, mask, mask_mode="key_query"), reps=9)
        plain_ms = time_ms(lambda: mod(inputs, mask, mask_mode="key_query",
                                       plain=True), reps=5)
    print(f"forward B={B} T={T} bf16: kernel path {ms:.3f} ms = "
          f"{B * 1000.0 / ms:.1f} seq/s; plain path {plain_ms:.3f} ms = "
          f"{B * 1000.0 / plain_ms:.1f} seq/s (median, CUDA events)", flush=True)
    return enc_launches, mfn_launches


def run_train_kernel_checks(torch, device):
    from multimodal_transformer_tpu_torch.ops.cuda import verify

    fns = (verify.check_encoder_train_fwd, verify.check_encoder_layer_bwd,
           verify.check_mfn_train_fwd, verify.check_mfn_train_bwd)
    checks = []
    for dtype in (torch.float32, torch.bfloat16):
        for T in TRAIN_T:
            for fn in fns:
                # timed at the main path's shape only
                checks.append(fn(32, T, dtype, device=device,
                                 reps=5 if T == BENCH_T else 0))
                print(checks[-1].line(), flush=True)
                if not checks[-1].ok:
                    for name, (e, p) in checks[-1].parts.items():
                        print(f"    {name}: err {e:.3e} plain err {p:.3e}",
                              flush=True)
    bad = [c for c in checks if not c.ok]
    if bad:
        raise SmokeFailure(f"{len(bad)} train kernel check(s) outside the "
                           "bound")
    return checks


class _Losses(logging.Handler):
    """Collects the running losses of the Engine's `Batch:` lines."""

    def __init__(self):
        super().__init__()
        self.values = []

    def emit(self, record):
        msg = record.getMessage()
        if msg.startswith("Batch:"):
            self.values.append(float(msg.split("Loss:")[1]))


def _bench_batch(np, Batch, cfg, B, T, seed):
    """bench.py's training batch: lengths T - (i % 5), random targets."""
    rs = np.random.RandomState(seed)
    data = {m: rs.randn(B, T, FRAMES[m], cfg.mod_dimension[m]).astype(
        np.float32) for m in AVL}
    target = rs.randn(B, T, 1).astype(np.float32)
    lens = [T - (i % 5) for i in range(B)]
    mask = np.zeros((B, T, 1), np.float32)
    for i, n in enumerate(lens):
        mask[i, :n] = 1.0
    return Batch(data, target, mask, lens)


def _grads(torch, engine, batch, seeds, plain):
    params = [p for _, p in engine.module.named_parameters()]
    loss = engine.batch_loss(batch, seeds, plain=plain)
    grads = torch.autograd.grad(loss / float(sum(batch.lengths)), params)
    return float(loss.detach()), grads


def _profile(torch, step, n: int):
    """Device time by kernel over n steps, and the device's busy share: the
    union of the intervals in which a kernel or a copy ran, over the host's
    wall time.  User annotations (e.g. the optimizer's step range) are not
    device work and are left out."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    cpu_names = {e.name for e in events if not str(e.device_type).endswith("CUDA")}
    dev = [e for e in events if str(e.device_type).endswith("CUDA")
           and not getattr(e, "is_user_annotation", False)
           and e.name not in cpu_names]
    busy, end = 0.0, -math.inf
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in dev):
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name: dict = {}
    for e in dev:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.end - e.time_range.start, c + 1)
    print(f"profile: {n} steps, wall {wall_us / 1e3 / n:.3f} ms/step, device "
          f"busy {busy / 1e3 / n:.3f} ms/step = {busy / wall_us:.3f} of the "
          f"wall time ({sum(t for t, _ in by_name.values()) / 1e3 / n:.3f} "
          "ms/step of kernels and copies summed)", flush=True)
    for name, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:16]:
        print(f"  {t / 1e3 / n:9.3f} ms/step {c // n:5d} calls/step "
              f"{name[:90]}", flush=True)


def run_train(torch, np, device):
    from multimodal_transformer_tpu_torch import default_config
    from multimodal_transformer_tpu_torch.data import Batch
    from multimodal_transformer_tpu_torch.engine import Engine
    from multimodal_transformer_tpu_torch.ops.cuda import encoder_train as enct
    from multimodal_transformer_tpu_torch.ops.cuda import mfn_train as mfnt
    from multimodal_transformer_tpu_torch.ops.cuda.verify import time_ms

    cfg = default_config("MFT", AVL, mask_mode="key_query")
    engine = Engine(cfg, seed=0, train_dtype=torch.bfloat16, device=device)
    losses = _Losses()
    log = logging.getLogger("chip_smoke.train")
    log.setLevel(logging.INFO)
    log.addHandler(losses)
    engine.logger = log
    rng = np.random.default_rng(2)
    lens = rng.integers(MIN_WINDOWS, MAX_WINDOWS + 1, size=TRAIN_VIDEOS)
    W = int(lens.max())
    data = {m: rng.standard_normal((TRAIN_VIDEOS, W, FRAMES[m],
                                    cfg.mod_dimension[m]), dtype=np.float32)
            for m in AVL}
    target = rng.standard_normal((TRAIN_VIDEOS, W), dtype=np.float32)
    steps = -(-TRAIN_VIDEOS // TRAIN_BATCH)

    enct.reset_launches()
    mfnt.reset_launches()
    t0 = time.perf_counter()
    epoch_loss = engine.train_epoch(data, target, list(lens),
                                    batch_size=TRAIN_BATCH,
                                    rng=np.random.RandomState(0))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {"encoder_stack_train_fwd": enct.fwd_launches,
           "encoder_layer_bwd": enct.bwd_launches,
           "mfn_train_fwd": mfnt.fwd_launches,
           "mfn_train_bwd": mfnt.bwd_launches}
    want = {"encoder_stack_train_fwd": 3 * steps,
            "encoder_layer_bwd": 3 * 6 * steps,
            "mfn_train_fwd": steps, "mfn_train_bwd": steps}
    print(f"trained 1 epoch of {TRAIN_VIDEOS} videos ({steps} steps of "
          f"batch {TRAIN_BATCH}, bf16 mixed, dropout on) in {wall:.3f} s "
          f"(first use); running losses {losses.values}, epoch loss "
          f"{epoch_loss:.5f}; launches {got}", flush=True)
    if got != want:
        raise SmokeFailure(f"expected launches {want} on the training path")
    if len(losses.values) != steps or not all(
            math.isfinite(v) for v in losses.values + [epoch_loss]):
        raise SmokeFailure("a training loss is not finite")

    # one fp32 step, kernel path against plain path
    from multimodal_transformer_tpu_torch.ops.seeds import DropoutSeeds

    B, T = BENCH_B, BENCH_T
    batch = _bench_batch(np, Batch, cfg, B, T, seed=3)
    f32 = Engine(cfg, seed=1, device=device)
    seeds = DropoutSeeds.draw(AVL, 6, T, torch.Generator().manual_seed(4))
    loss_k, g_k = _grads(torch, f32, batch, seeds, plain=False)
    loss_p, g_p = _grads(torch, f32, batch, seeds, plain=True)
    _, g_k2 = _grads(torch, f32, batch, seeds, plain=False)
    names = [n for n, _ in f32.module.named_parameters()]
    total = torch.sqrt(sum((g.double() ** 2).sum() for g in g_p)).item()
    worst, worst_name = 0.0, ""
    for name, a, b in zip(names, g_k, g_p):
        diff = (a.double() - b.double()).norm().item()
        limit = GRAD_RTOL * b.double().norm().item() + GRAD_FLOOR * total
        if diff / limit > worst:
            worst, worst_name = diff / limit, name
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    same = all(torch.equal(a, b) for a, b in zip(g_k, g_k2))
    print(f"fp32 step B={B} T={T}: loss kernel {loss_k:.6f} plain "
          f"{loss_p:.6f} (rel {loss_rel:.2e}, tol {LOSS_RTOL:.0e}); worst "
          f"gradient {worst_name}: {worst:.3f} of its limit "
          f"({GRAD_RTOL:.0e} rel L2 + {GRAD_FLOOR:.0e} of |all grads| = "
          f"{total:.4e}); repeated step bit-identical: {same}", flush=True)
    if loss_rel > LOSS_RTOL or worst > 1.0:
        raise SmokeFailure("the fp32 kernel-path step disagrees with the "
                           "plain path")
    if not same:
        raise SmokeFailure("the same step twice gave different gradients")

    mixed = Engine(cfg, seed=1, train_dtype=torch.bfloat16, device=device)
    on_card = Batch({m: torch.from_numpy(v).to(device, torch.bfloat16)
                     for m, v in batch.data.items()},
                    torch.from_numpy(batch.target).to(device),
                    torch.from_numpy(batch.mask).to(device, torch.bfloat16),
                    batch.lengths)
    ms = time_ms(lambda: mixed.train_step(batch), reps=9)
    card_ms = time_ms(lambda: mixed.train_step(on_card), reps=9)
    plain_ms = time_ms(lambda: mixed.train_step(on_card, plain=True),
                       reps=3, warmup=1)
    print(f"train step B={B} T={T} bf16 mixed (fwd + bwd + Adam), median, "
          f"CUDA events: kernel path {ms:.3f} ms/step from a host batch, "
          f"{card_ms:.3f} ms/step from a batch on the card; plain path "
          f"{plain_ms:.3f} ms/step from a batch on the card", flush=True)
    for what, b in (("host batch", batch), ("batch on the card", on_card)):
        print(f"profile of the kernel path, {what}:", flush=True)
        try:
            _profile(torch, lambda: mixed.train_step(b), 5)
        except Exception as e:  # the profiler is a reading, not a check
            print(f"profile: not available ({type(e).__name__}: {e})",
                  flush=True)
    return got


def main() -> int:
    import torch

    phase("gate")
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device; chip_smoke.py runs only on a GPU",
              file=sys.stderr)
        return 1
    print(card_line(), flush=True)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import numpy as np

    here = Path(__file__).resolve().parent
    if not (here / "multimodal_transformer_tpu_torch" / "csrc").is_dir():
        raise SmokeFailure(f"run from a checkout of the repository: {here} "
                           "holds no multimodal_transformer_tpu_torch/csrc")
    sys.path.insert(0, str(here))
    from multimodal_transformer_tpu_torch.ops.cuda import _build

    phase("build")
    t0 = time.perf_counter()
    lib_path = _build.build(verbose=True)
    _build.load()
    print(f"built {lib_path.name} in {time.perf_counter() - t0:.1f} s",
          flush=True)

    phase("kernels against their plain versions")
    checks = run_kernel_checks(torch, device)

    phase("slice")
    enc_launches, mfn_launches = run_slice(torch, np, device)

    phase("train kernels against their plain versions")
    checks += run_train_kernel_checks(torch, device)

    phase("train")
    launches = run_train(torch, np, device)

    main_case = {c.name: c for c in checks
                 if c.dtype == "bfloat16" and c.shape.startswith("B=32 T=160 ")}
    launches.update({"encoder_stack_fused": enc_launches,
                     "mfn_scan_fused": mfn_launches})
    kernels = []
    for name, (source, replaces) in SOURCES.items():
        c = main_case[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": c.err, "ms": c.ms,
                        "plain_ms": c.plain_ms})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        sys.exit(1)
