"""Time kernel B (`ops/cuda/mfn.py:mfn_scan_fused`) of a checkout on the card.

For comparing two versions of the kernel in one session: run it once per
checkout, alternating (A, B, B, A), from any directory.  `--tree` names the
checkout whose package is imported (default: the one holding this file); a
checkout older than this script works too, since only its
`ops/cuda/verify.py` helpers (`_mfn_case`, `time_ms`) and its wrapper are
used.  Shapes are those chip_smoke.py checks kernel B at, plus B=32, T=1,120:
(B, T, modalities).  Each line is the median of 7 bursts of 5 calls (CUDA
events), seeded random weights and inputs; where the checkout's verify.py
has `mfn_stage_ms`, the device time of each stage at B=32, T=160 follows.

    python multimodal_transformer_tpu_torch/bench_kernel_b.py [--tree DIR]
"""

from __future__ import annotations

import argparse
import os
import sys

AVL = ("acoustic", "image", "linguistic")
SHAPES = ((32, 160, AVL), (3, 7, ("linguistic", "acoustic")),
          (4, 9, ("emotient", "acoustic")), (2, 1120, AVL), (1, 37, AVL),
          (32, 1120, AVL))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    from multimodal_transformer_tpu_torch.ops.cuda import mfn, verify

    if not torch.cuda.is_available():
        print("no CUDA device: kernel B runs only on the card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name = os.path.basename(tree)
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        for B, T, mods in SHAPES:
            _, xps, whhs, gates = verify._mfn_case(B, T, dtype, dev, 0, mods)
            with torch.no_grad():
                ms = verify.time_ms(lambda: mfn.mfn_scan_fused(xps, whhs, gates),
                                    reps=7, burst=5)
            print(f"[{name}] kernel B B={B} T={T} "
                  f"{'+'.join(m[0] for m in mods)} {dname} {ms:.4f} ms",
                  flush=True)
        if hasattr(verify, "mfn_stage_ms"):
            stages = verify.mfn_stage_ms(32, 160, dtype, device=dev)
            print(f"[{name}] stages {dname} " + ", ".join(
                f"{k} {v:.4f}" for k, v in stages.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
