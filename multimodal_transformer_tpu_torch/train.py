"""Training/evaluation CLI of the PyTorch port, on the card.

Counterpart of the JAX package's `train.py` (reference MFT/train.py:522-644,
SFT/train.py:520-660, Performance-Eval/train.py:512-606), one entry point
for the five families:

  python -m multimodal_transformer_tpu_torch.train --family MFT   # comb x acoustic-dim sweep
  python -m multimodal_transformer_tpu_torch.train --family SFT   # the fixed combo
  ... --family SFT --eval --load CKPT     # Valid evaluation + PredSave dump
  ... --family SFT --test --load CKPT     # Test evaluation + PredSave dump
  ... --perf --model_save DIR             # PerfSave sweep over .pth / .ckpt
  ... --resume                            # continue from CKPT.state

Checkpoints are the reference's `.pth` (`{modalities, mod_dimension,
window_size, model}`, named `{family}-{comb}[-{acoustic_dim}].pth`), which
the JAX CLI also reads; `--eval`, `--test` and `--perf` also read the JAX
package's `.ckpt` files.  Log lines, PredSave and PerfSave CSVs are the
reference's.  Flags that differ from the JAX CLI:

  --device          cuda (default) or cpu; without a card, cuda exits
                    nonzero: nothing falls back to the CPU;
  --dropout_impl    only "hash" (the fmix32 hash dropout of the kernels);
  --visualize       refused: the plots need matplotlib, which the port
                    does not import;
  --fast_rng, --ckpt_backend   not taken (a TPU PRNG and the orbax backend).

Flags the reference parses but never uses (--split, --sup_ratio,
--normalize, ...) are accepted.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import signal
import sys

import numpy as np
import torch

from .data import generate_synthetic_send, load_send, window_pipeline
from .engine import (Engine, append_perf_save, get_logger, load_model,
                     save_checkpoint, seq_id_strings, write_pred_save)
from .models import FAMILIES, default_config, modalities_from_comb

# PredSave dump videos (reference SFT/train.py:600-607)
PRED_SAVE_VIDEO = {"Valid": "173_4", "Test": "165_2"}


def comb_string(modalities) -> str:
    letters = {"image": "V", "acoustic": "A", "linguistic": "L"}
    return "".join(letters[m] for m in modalities if m in letters)


def apply_window_override(cfg, spec, logger):
    """Resolve --window_size and the B1 multimodal preset.

    spec: None, "N" (all channels = N seconds), or "chan=N,chan=N,...".
    Without a spec, B1-LSTM lifts any 1-s feature channel to the 5-s rating
    resolution: the reference's B1 config (B1-LSTM/train.py:529) makes
    oversample = int(1/5) = 0 for acoustic/image/emotient, which silently
    yields zero windows per video (B1-LSTM/train.py:375-396), yet its
    PerfSave table has A/V/AL/AV/ALV rows, so the multimodal checkpoints
    must have carried compatible window sizes in their metadata."""
    ws = dict(cfg.window_size)
    if spec is None:
        if cfg.family == "B1-LSTM":
            r = ws["ratings"]
            lifted = sorted(m for m in cfg.modalities if ws.get(m, r) < r)
            if lifted:
                ws.update({m: r for m in lifted})
                logger.info("B1 multimodal: lifting window_size of %s to "
                            "%gs (rating resolution); --window_size "
                            "overrides", lifted, r)
                return dataclasses.replace(cfg, window_size=ws)
        return cfg
    if "=" not in spec:
        try:
            ws = {k: int(spec) for k in ws}
        except ValueError:
            sys.exit(f"error: --window_size: expected an integer or "
                     f"chan=int[,chan=int...], got {spec!r}")
    else:
        for part in spec.split(","):
            try:
                k, v = part.split("=")
                val = int(v)
            except ValueError:
                sys.exit(f"error: --window_size: malformed entry {part!r} "
                         f"(expected chan=int)")
            if k.strip() not in ws:
                sys.exit(f"error: --window_size: unknown channel {k!r} "
                         f"(have {sorted(ws)})")
            ws[k.strip()] = val
    return dataclasses.replace(cfg, window_size=ws)


def prepare_data(cfg, data_dir, subset, linguistic_variant="glove"):
    ds = load_send(list(cfg.modalities), data_dir, subset,
                   linguistic_variant=linguistic_variant)
    padded, targets, seq_lens = window_pipeline(
        ds, cfg.window_size, cfg.modalities, cfg.mod_dimension)
    return ds, padded, targets, seq_lens


def linguistic_variant(cfg) -> str:
    """B1-LSTM reads the BERT features, but for its legacy variant."""
    return ("bert" if cfg.family == "B1-LSTM" and cfg.variant != "legacy"
            else "glove")


def train_one(args, cfg, ckpt_path, logger):
    lvar = linguistic_variant(cfg)
    _, tr_x, tr_y, tr_l = prepare_data(cfg, args.data_dir, "Train", lvar)
    _, va_x, va_y, va_l = prepare_data(cfg, args.data_dir, "Valid", lvar)
    train_dtype = torch.bfloat16 if args.mixed_precision else None
    eng = Engine(cfg, lr=args.lr, seed=1, logger=logger,
                 train_dtype=train_dtype, device=args.device)
    # Preemption save: on SIGTERM finish the current epoch, save the whole
    # train state and exit 143; `--resume` picks up exactly there.
    preempted = []

    def _on_sigterm(sig, frame):
        preempted.append(sig)
        logger.info("SIGTERM received - saving state at the next epoch "
                    "boundary")

    # made afresh here, on resume too, as the JAX CLI does: a resumed run
    # shuffles its epochs as a new run's first epochs
    rng = np.random.RandomState(1)
    best_ccc, single_best_ccc = -1.0, -1.0
    state_path = ckpt_path + ".state"
    start_epoch = 1
    if args.resume and os.path.exists(state_path):
        best_ccc = eng.restore_state(state_path)
        start_epoch = eng._epoch + 1
        logger.info('Resumed from {} at epoch {} (best CCC {:0.6f})'.format(
            state_path, start_epoch, best_ccc))
    store = None
    if args.resident_train:
        if cfg.mask_mode != "key_query":
            sys.exit("error: --resident_train requires --mask_mode key_query "
                     "(full-padded batches are only exact with key masking)")
        store = eng.upload_dataset(tr_x, tr_y, tr_l)
    # Install the hook only for the epoch loop and always restore the prior
    # handler: train_one is also called in-process (tests, library use), and
    # a leaked handler bound to a dead `preempted` list would swallow later
    # SIGTERMs to the process.
    prev_sigterm = signal.getsignal(signal.SIGTERM)
    signal.signal(signal.SIGTERM, _on_sigterm)
    try:
        for epoch in range(start_epoch, args.epochs + 1):
            print("---")
            if store is not None:
                eng.train_epoch_resident(store, batch_size=args.batch_size,
                                         rng=rng)
            else:
                eng.train_epoch(tr_x, tr_y, tr_l, batch_size=args.batch_size,
                                rng=rng)
            if epoch % args.eval_freq == 0:
                _, _, _, loss, stats, (bo, bt, bi) = eng.evaluate_per_video(
                    va_x, va_y, va_l)
                if cfg.family != "B1-LSTM":  # B1: no scheduler (train.py:593)
                    eng.scheduler_step(loss)
                if stats["ccc"] > best_ccc:
                    best_ccc = stats["ccc"]
                    save_checkpoint(cfg, eng.module.state_dict(), ckpt_path)
                if stats["max_ccc"] > single_best_ccc:
                    single_best_ccc = stats["max_ccc"]
                    logger.info('===single_max_predict===')
                    logger.info(bo)
                    logger.info(bt)
                    logger.info(bi)
                    logger.info('===end single_max_predict===')
                logger.info(
                    'CCC_STATS\tSINGLE_BEST: {:0.9f}\tBEST: {:0.9f}'.format(
                        single_best_ccc, best_ccc))
            if epoch % args.save_freq == 0 or preempted:
                eng.save_state(state_path, best_ccc)
            if preempted:
                logger.info('Preempted: state saved to {} after epoch {}; '
                            'rerun with --resume to continue'.format(
                                state_path, epoch))
                sys.exit(143)
    finally:
        signal.signal(signal.SIGTERM, prev_sigterm)
    return best_ccc


def eval_engine(path, family, mask_mode, logger, device):
    """An Engine holding the weights of a `.pth` (reference layout) or of
    the JAX package's `.ckpt`, its configuration read from the file."""
    cfg, state = load_model(path, family, mask_mode=mask_mode)
    eng = Engine(cfg, logger=logger, device=device)
    eng.module.load_state_dict({k: torch.from_numpy(v)
                                for k, v in state.items()})
    return eng


def eval_mode(args, logger):
    eval_dir = "Valid" if args.eval else "Test"
    print("evaluating on the " + eval_dir + " Set.")
    family = args.family
    mask_mode = "key_query" if args.fast_eval else args.mask_mode
    eng = eval_engine(args.load, family, mask_mode, logger, args.device)
    ds, x, y, lens = prepare_data(eng.cfg, args.data_dir, eval_dir,
                                  linguistic_variant(eng.cfg))
    if args.fast_eval:
        # fixed-shape length buckets, exact in "key_query" mode
        cccs, _, stats = eng.evaluate_batched(x, y, lens)
        preds = actuals = None
    else:
        cccs, preds, actuals, _, stats, _ = eng.evaluate_per_video(x, y, lens)
    logger.info('Evaluation\tCCC(std): {:2.5f}({:2.5f})'.format(
        stats["ccc"], stats["ccc_std"]))
    seq_ids = seq_id_strings(ds.seq_ids)
    if preds is None:
        return stats  # the batched path keeps no per-step traces
    vid = PRED_SAVE_VIDEO[eval_dir]
    if vid in seq_ids:
        i = seq_ids.index(vid)
        write_pred_save(os.path.join(args.pred_save_dir,
                                     f"{family}{vid}.csv"),
                        preds[i], actuals[i])
    return stats


def parse_ckpt_name(name):
    """{family}-{comb}[-{acoustic_dim}].{ckpt|pth} -> (family, comb,
    acoustic_dim, model_str); family may contain '-' (B1-LSTM).
    Reference filename parse: Performance-Eval/train.py:533-545."""
    parts = name.rsplit(".", 1)[0].split("-")
    acoustic_dim = 88
    if parts[-1].isdigit():
        acoustic_dim = int(parts[-1])
        comb = parts[-2]
        model_str = "-".join(parts[:-2]) + "-" + parts[-1]
        family = "-".join(parts[:-2])
    else:
        comb = parts[-1]
        model_str = "-".join(parts[:-1])
        family = model_str
    return family, comb, acoustic_dim, model_str


def perf_mode(args, logger):
    """PerfSave sweep (reference Performance-Eval/train.py:529-573) over
    every .pth and .ckpt under --model_save.  Windowed splits are cached
    across checkpoints of the same windowing."""
    out = os.path.basename(os.path.normpath(args.model_save))
    data_cache = {}

    def cached_prepare(cfg, eval_dir, lvar):
        key = (cfg.modalities, tuple(sorted(cfg.mod_dimension.items())),
               tuple(sorted(cfg.window_size.items())), eval_dir, lvar)
        if key not in data_cache:
            data_cache[key] = prepare_data(cfg, args.data_dir, eval_dir,
                                           lvar)
        return data_cache[key]
    mask_mode = "key_query" if args.fast_eval else args.mask_mode
    for root, _, files in os.walk(args.model_save):
        for name in sorted(files):
            if not name.endswith((".ckpt", ".pth")):
                continue
            family, comb, _, model_str = parse_ckpt_name(name)
            mod_str = "".join(sorted(comb))
            eng = eval_engine(os.path.join(root, name), family, mask_mode,
                              logger, args.device)
            for eval_dir in ["Train", "Valid", "Test"]:
                print(f"Evaluating {model_str} with {mod_str} performances "
                      f"on {eval_dir}")
                ds, x, y, lens = cached_prepare(
                    eng.cfg, eval_dir, linguistic_variant(eng.cfg))
                if args.fast_eval:
                    cccs, _, stats = eng.evaluate_batched(x, y, lens)
                else:
                    cccs, _, _, _, stats, _ = eng.evaluate_per_video(
                        x, y, lens)
                logger.info('Evaluation\tCCC(std): {:2.5f}({:2.5f})'.format(
                    stats["ccc"], stats["ccc_std"]))
                append_perf_save(
                    os.path.join(args.perf_save_dir, out + ".csv"),
                    model_str, mod_str, seq_id_strings(ds.seq_ids), cccs,
                    eval_dir)


def build_arg_parser():
    parser = argparse.ArgumentParser(
        prog="python -m multimodal_transformer_tpu_torch.train")
    parser.add_argument('--family', type=str, default="MFT",
                        help='model family: MFT|SFT|B1-LSTM|B2-Trans|B3-MFN')
    parser.add_argument('--modalities', type=str, default=None, nargs='+',
                        help='input modalities (default: family preset)')
    parser.add_argument('--comb', type=str, default=None,
                        help="combination letters, e.g. VAL (V=image, "
                             "A=acoustic, L=linguistic)")
    parser.add_argument('--batch_size', type=int, default=25, metavar='N',
                        help='input batch size for training (default: 25)')
    parser.add_argument('--split', type=int, default=1, metavar='N')
    parser.add_argument('--epochs', type=int, default=500, metavar='N',
                        help='number of epochs to train (default: 500)')
    parser.add_argument('--lr', type=float, default=1e-4, metavar='LR',
                        help='learning rate (default: 1e-4)')
    parser.add_argument('--sup_ratio', type=float, default=0.5, metavar='F')
    parser.add_argument('--base_rate', type=float, default=2.0, metavar='N')
    parser.add_argument('--log_freq', type=int, default=5, metavar='N')
    parser.add_argument('--eval_freq', type=int, default=1, metavar='N')
    parser.add_argument('--save_freq', type=int, default=10, metavar='N')
    parser.add_argument('--device', type=str, default='cuda',
                        help='torch device (default: cuda; cpu for tests)')
    parser.add_argument('--visualize', action='store_true', default=False,
                        help='not available: the plots need matplotlib')
    parser.add_argument('--normalize', action='store_true', default=False)
    parser.add_argument('--test', action='store_true', default=False,
                        help='evaluate on test set')
    parser.add_argument('--eval', action='store_true', default=False,
                        help='evaluate on eval (Valid) set')
    parser.add_argument('--perf', action='store_true', default=False,
                        help='PerfSave sweep over saved checkpoints')
    parser.add_argument('--load', type=str, default=None,
                        help='path to trained model checkpoint')
    parser.add_argument('--resume', action='store_true', default=False,
                        help='resume training from the saved .state file '
                             '(written every --save_freq epochs)')
    parser.add_argument('--data_dir', type=str, default="../../../SENDv1-data")
    parser.add_argument('--save_dir', type=str, default="./ModelSave")
    parser.add_argument('--pred_save_dir', type=str, default="./PredSave")
    parser.add_argument('--perf_save_dir', type=str, default="./PerfSave")
    parser.add_argument('--model_save', type=str, default="./ModelSave/MFT",
                        help='checkpoint dir for --perf sweeps')
    parser.add_argument('--mask_mode', type=str, default="query",
                        choices=["query", "key_query"])
    parser.add_argument('--window_size', type=str, default=None,
                        help='override channel window seconds: a single '
                             'number for all channels, or "chan=N,chan=N" '
                             '(channels: modalities + ratings).  Without '
                             'it, B1-LSTM lifts 1-s feature channels to '
                             'the 5-s rating window so multimodal combos '
                             'are trainable')
    parser.add_argument('--mixed_precision', action='store_true',
                        default=False,
                        help='bf16 forward/backward with fp32 master '
                             'params + Adam')
    parser.add_argument('--dropout_impl', type=str, default='hash',
                        choices=['hash'],
                        help='dropout mask generator: the counter-based '
                             'fmix32 hash (the only one the kernels draw)')
    parser.add_argument('--resident_train', action='store_true',
                        default=False,
                        help='device-resident training: upload the split '
                             'once, gather batches on the device (requires '
                             '--mask_mode key_query)')
    parser.add_argument('--fast_eval', action='store_true', default=False,
                        help='batched evaluation over fixed-shape length '
                             'buckets (forces key_query mask mode)')
    parser.add_argument('--acoustic_dims', type=int, nargs='+',
                        default=[88, 44],
                        help='MFT acoustic window-embed sweep (default 88 44)')
    parser.add_argument('--log_file', type=str, default="./train_cnn.log")
    parser.add_argument('--synthetic_data', action='store_true', default=False,
                        help='generate a synthetic mini-SENDv1 tree into '
                             '--data_dir if it is missing')
    return parser


def main(args):
    if args.visualize:
        sys.exit("error: --visualize is not available here: the plots need "
                 "matplotlib, which this package does not import")
    if (torch.device(args.device).type == "cuda"
            and not torch.cuda.is_available()):
        sys.exit(f"error: --device {args.device}: no CUDA device is "
                 "available (pass --device cpu to run on the CPU)")
    if args.family not in FAMILIES:
        sys.exit(f"error: unknown --family {args.family!r}; "
                 f"expected one of {', '.join(FAMILIES)}")
    np.random.seed(1)
    logger = get_logger(args.log_file)

    if args.synthetic_data and not os.path.isdir(
            os.path.join(args.data_dir, "features")):
        print("Generating synthetic mini-SENDv1 into", args.data_dir)
        subsets = {"Train": 8, "Valid": 3, "Test": 3}
        generate_synthetic_send(args.data_dir, subsets, duration_s=60.0)
        # B1-LSTM reads BERT-1024 linguistic features from a sibling dir
        generate_synthetic_send(args.data_dir, subsets, duration_s=60.0,
                                modalities=("linguistic",),
                                linguistic_variant="bert")

    if args.perf:
        return perf_mode(args, logger)
    if args.test or args.eval:
        if not args.load:
            sys.exit("error: --eval/--test require --load CKPT")
        if not os.path.exists(args.load):
            sys.exit(f"error: checkpoint not found: {args.load}")
        return eval_mode(args, logger)

    family = args.family
    if family == "MFT" and args.comb is None and args.modalities is None:
        # the reference MFT main sweeps combs x acoustic dims
        # (MFT/train.py:538-541)
        best = -1.0
        for a_dim in args.acoustic_dims:
            for comb in ["VA", "AL", "VAL"]:
                name = f"MFT-{comb}-{a_dim}.pth"
                print("Running output as -", os.path.join(args.save_dir,
                                                          "MFT"), name)
                cfg = default_config("MFT", modalities_from_comb(comb),
                                     acoustic_embed=a_dim,
                                     mask_mode=args.mask_mode)
                cfg = apply_window_override(cfg, args.window_size, logger)
                ckpt = os.path.join(args.save_dir, "MFT", name)
                best = max(best, train_one(args, cfg, ckpt, logger))
        return best

    # fixed-combo training (SFT/B1/B2/B3 mains, or explicit --comb)
    defaults = {"SFT": "VL", "B1-LSTM": "L", "B2-Trans": "VL",
                "B3-MFN": "VAL", "MFT": "VAL"}
    comb = args.comb or defaults[family]
    mods = (tuple(args.modalities) if args.modalities
            else modalities_from_comb(comb))
    cfg = default_config(family, mods, mask_mode=args.mask_mode)
    cfg = apply_window_override(cfg, args.window_size, logger)
    # keep the user's comb spelling in the filename (reference names are
    # comb-as-typed, e.g. SFT-VL.pth, MFT-VAL-88.pth)
    name = f"{family}-{comb if args.comb else comb_string(mods)}.pth"
    ckpt = os.path.join(args.save_dir, family, name)
    print("Running output as -", os.path.join(args.save_dir, family), name)
    return train_one(args, cfg, ckpt, logger)


if __name__ == "__main__":
    main(build_arg_parser().parse_args())
