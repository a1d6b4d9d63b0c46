"""End-to-end walkthrough: data -> train -> checkpoint -> eval -> artifacts
-> serving, on a synthetic mini-SENDv1 tree.

    python -m multimodal_transformer_tpu_torch.walkthrough [--workdir DIR]
        [--epochs N] [--device cpu]

Counterpart of the JAX package's examples/walkthrough.py, the same five
steps, on the card unless --device cpu (without a card and without it, it
exits nonzero):

  1. generate a SENDv1-schema tree of 6 / 3 / 3 videos of 40 s
     (data/synthetic.py);
  2. train B3-MFN (acoustic + linguistic) with the reference protocol
     (Adam at 1e-3 + plateau LR, batch 3, per-video CCC on Valid,
     checkpoint-on-best to ModelSave/B3-MFN/B3-MFN-AL.pth);
  3. reload the checkpoint (its configuration from the file) and evaluate
     each Test video;
  4. write the PerfSave and PredSave CSVs (the prediction plots of the JAX
     walkthrough need matplotlib, which this package does not import);
  5. serve the Test split in bf16 through
     `ValencePredictor.from_checkpoint(..., batch_size=4, time_multiple=16)`.

On the card this runs kernel 10 (every front end), kernels 6 and 7 (the
MFN's training recurrence) and kernel B (its evaluation and serving).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", default="./walkthrough_out")
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap


def main(argv=None) -> dict:
    """Runs the five steps; returns the checkpoint's path, the Test
    statistics and the served traces ({"subj_vid": [W] float32})."""
    args = build_arg_parser().parse_args(argv)
    if (torch.device(args.device).type == "cuda"
            and not torch.cuda.is_available()):
        sys.exit(f"error: --device {args.device}: no CUDA device is "
                 "available (pass --device cpu to run on the CPU)")

    from .data import generate_synthetic_send, load_send, window_pipeline
    from .engine import (Engine, append_perf_save, get_logger, load_model,
                         save_checkpoint, seq_id_strings, write_pred_save)
    from .models import default_config
    from .serve import ValencePredictor

    wd = os.path.abspath(args.workdir)
    data_dir = os.path.join(wd, "SENDv1-data")
    os.makedirs(wd, exist_ok=True)
    logger = get_logger(os.path.join(wd, "train_cnn.log"))

    # 1. data
    if not os.path.isdir(os.path.join(data_dir, "features")):
        print("[1/5] generating synthetic mini-SENDv1 ...")
        generate_synthetic_send(data_dir, {"Train": 6, "Valid": 3, "Test": 3},
                                duration_s=40.0)
    cfg = default_config("B3-MFN", ("acoustic", "linguistic"))

    def prep(subset):
        ds = load_send(list(cfg.modalities), data_dir, subset)
        return ds, *window_pipeline(ds, cfg.window_size, cfg.modalities,
                                    cfg.mod_dimension)

    _, tr_x, tr_y, tr_l = prep("Train")
    _, va_x, va_y, va_l = prep("Valid")

    # 2. train
    print(f"[2/5] training B3-MFN for {args.epochs} epochs ...")
    eng = Engine(cfg, lr=1e-3, seed=1, logger=logger, device=args.device)
    rng = np.random.RandomState(1)
    ckpt = os.path.join(wd, "ModelSave", "B3-MFN", "B3-MFN-AL.pth")
    best = -1.0
    for _ in range(args.epochs):
        eng.train_epoch(tr_x, tr_y, tr_l, batch_size=3, rng=rng)
        _, _, _, loss, stats, _ = eng.evaluate_per_video(va_x, va_y, va_l)
        eng.scheduler_step(loss)
        if stats["ccc"] > best:
            best = stats["ccc"]
            save_checkpoint(cfg, eng.module.state_dict(), ckpt)
    print(f"    best valid CCC {best:+.4f}; checkpoint: {ckpt}")

    # 3. reload + Test eval (config restored from the checkpoint)
    print("[3/5] reloading checkpoint, evaluating on Test ...")
    _, state = load_model(ckpt, "B3-MFN")
    eng.module.load_state_dict({k: torch.from_numpy(v)
                                for k, v in state.items()})
    test_ds, te_x, te_y, te_l = prep("Test")
    cccs, preds, actuals, _, stats, _ = eng.evaluate_per_video(te_x, te_y,
                                                              te_l)
    print(f"    Test CCC {stats['ccc']:+.4f} (±{stats['ccc_std']:.4f})")

    # 4. artifacts
    print("[4/5] writing PerfSave/PredSave artifacts ...")
    seq_ids = seq_id_strings(test_ds.seq_ids)
    append_perf_save(os.path.join(wd, "PerfSave", "B3-MFN.csv"),
                     "B3-MFN", "AL", seq_ids, cccs, "Test")
    write_pred_save(os.path.join(wd, "PredSave", f"B3-MFN{seq_ids[0]}.csv"),
                    preds[0], actuals[0])
    print("    prediction plots are not carried over: they need matplotlib, "
          "which this package does not import")

    # 5. serving
    print("[5/5] serving: bucketed bf16 inference ...")
    predictor = ValencePredictor.from_checkpoint(ckpt, "B3-MFN",
                                                 device=args.device,
                                                 batch_size=4,
                                                 time_multiple=16)
    traces = predictor.predict_dataset(test_ds)
    sid = seq_ids[0]
    print(f"    {len(traces)} videos served; '{sid}' trace head:",
          np.round(traces[sid][:5], 3))
    print("done; artifacts under", wd)
    return {"checkpoint": ckpt, "test_stats": stats, "traces": traces}


if __name__ == "__main__":
    main()
