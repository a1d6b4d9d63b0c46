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
  lengths in a batch (one whole video at B=1);
- `b`: kernel B (`ops/cuda/mfn.py:mfn_scan_fused`) at the shapes
  chip_smoke.py checks it at, plus B=32, T=1,120; where the checkout's
  verify.py has `mfn_stage_ms`, the device time of each stage at B=32,
  T=160 follows;
- `bwd`: kernels 4 and 5 (`ops/cuda/encoder_train.py:encoder_layer_bwd` and
  `encoder_stack_bwd`, the encoder's training backward) at B=32, T in {160,
  137, 400} (the training batch, a ragged one, and the longest the training
  phase sends); D=256, h=8, F=128, p=0.1, kernel 4 on one layer, kernel 5
  on a stack of 6 from kernel 3's saved inputs.

Seeded random weights and inputs, bf16 then fp32.  Each line is the median
of 7 bursts of 5 calls (CUDA events); for `a` and `bwd` the host's time to
enqueue one call follows (the wrapper and its launches, the card idle
before it; median of 7, perf_counter).

    python multimodal_transformer_tpu_torch/bench_kernels.py {a,b,bwd} [--tree DIR]
"""

from __future__ import annotations

import argparse
import functools
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


def bench_bwd(torch, verify, dev, dtype, dname):
    from multimodal_transformer_tpu_torch.ops.cuda import encoder_train as et

    for B, T in BWD_SHAPES:
        gen, params, x, kmask, seeds = verify._encoder_train_case(
            B, T, dtype, dev, 0, 256, 128, LAYERS)
        with torch.no_grad():
            _, saved = et.encoder_stack_train_fwd(params, x, kmask, seeds, P,
                                                  H)
            dy = torch.randn(B, T, 256, generator=gen).to(dev) \
                * kmask[..., None]
            calls = {
                "kernel 4": functools.partial(
                    et.encoder_layer_bwd, params[:16], saved[0], dy, kmask,
                    seeds[0], P, H),
                "kernel 5": functools.partial(
                    et.encoder_stack_bwd, params, saved, dy, kmask, seeds, P,
                    H)}
            for what, call in calls.items():
                yield (f"{what} B={B} T={T} {dname} "
                       f"{timed(torch, verify, call)}")


BENCHES = {"a": bench_a, "b": bench_b, "bwd": bench_bwd}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("kernel", choices=sorted(BENCHES))
    ap.add_argument("--tree", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    from multimodal_transformer_tpu_torch.ops.cuda import verify

    if not torch.cuda.is_available():
        print("no CUDA device: the kernels run only on the card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name = os.path.basename(tree)
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        for line in BENCHES[args.kernel](torch, verify, dev, dtype, dname):
            print(f"[{name}] {line}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
