"""Time kernel A (`ops/cuda/encoder.py:encoder_stack_fused`) of a checkout on
the card.

For comparing two versions of the kernel in one session: run it once per
checkout, alternating (A, B, B, A), from any directory.  `--tree` names the
checkout whose package is imported (default: the one holding this file); a
checkout older than this script works too, since only its
`ops/cuda/verify.py` helpers (`random_encoder`, `_key_mask`, `time_ms`) and
its wrapper are used.  Shapes: the serving batch, B=32 at T in {160, 137,
544}, and one video (per-video evaluation), B=1 at T in {37, 512}; D=256,
h=8, F=128, 6 layers, seeded random weights, varied lengths in a batch (one
whole video at B=1); fp32 and bf16.
Each line is the median of 7 bursts of 5 calls (CUDA events), then the
host's time to enqueue one call (the wrapper and its launches, the card
idle before it; median of 7, perf_counter).

    python multimodal_transformer_tpu_torch/bench_kernel_a.py [--tree DIR]
"""

from __future__ import annotations

import argparse
import functools
import os
import statistics
import sys
import time

SHAPES = ((32, 160), (32, 137), (32, 544), (1, 37), (1, 512))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    from multimodal_transformer_tpu_torch.ops.cuda import encoder, verify

    if not torch.cuda.is_available():
        print("no CUDA device: kernel A runs only on the card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name = os.path.basename(tree)
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        enc = verify.random_encoder(torch.Generator().manual_seed(0)).to(
            device=dev, dtype=dtype)
        for B, T in SHAPES:
            gen = torch.Generator().manual_seed(B * T)
            x = torch.randn(B, T, 256, generator=gen).to(device=dev,
                                                         dtype=dtype)
            mask = (verify._key_mask(B, T, 0, dtype, dev) if B > 1 else
                    torch.ones(B, T, 1, device=dev, dtype=dtype))
            with torch.no_grad():
                call = functools.partial(encoder.encoder_stack_fused, enc, x,
                                         mask)
                ms = verify.time_ms(call, reps=7, burst=5)
                host = []
                for _ in range(7):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    call()
                    host.append((time.perf_counter() - t0) * 1e3)
                torch.cuda.synchronize()
            print(f"[{name}] kernel A B={B} T={T} {dname} {ms:.4f} ms, host "
                  f"{statistics.median(host):.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
