#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it.

Run from the repository root: `python3 chip_smoke.py`.  Four phases, any
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
   bf16 forwards are timed.

The line before the last is a JSON object with each kernel's launches, error
and times; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import copy
import json
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
REQUESTS, VIDEOS, MAX_WINDOWS = 3, 20, 400
BENCH_B, BENCH_T = 32, 160
SOURCES = {
    "encoder_stack_fused": ("multimodal_transformer_tpu_torch/csrc/encoder.cu",
                            "multimodal_transformer_tpu/ops/pallas/encoder.py:313"),
    "mfn_scan_fused": ("multimodal_transformer_tpu_torch/csrc/mfn.cu",
                       "multimodal_transformer_tpu/ops/pallas/mfn_kernel.py:145"),
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
        lens = rng.integers(20, MAX_WINDOWS + 1, size=VIDEOS)
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

    main_case = {c.name: c for c in checks
                 if c.dtype == "bfloat16" and c.shape.startswith("B=32 T=160 ")}
    launches = {"encoder_stack_fused": enc_launches,
                "mfn_scan_fused": mfn_launches}
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
