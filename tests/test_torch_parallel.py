"""Port parity for data and tensor parallelism (parallel/), float32 on the
CPU, ranks on gloo over a FileStore:

  * `pad_batch_rows` equal to the JAX package's;
  * `DropoutSeeds.for_rows`: for every dropout site, a rank's mask at its
    rows of a batch of 5 rows over 2 ranks is the global (padded) batch's
    mask at those rows; unshifted seeds give another mask (the negative
    control); the same on the threefry stream, where the rank's keys
    (`prng.RowKeys`) draw its rows' counters and the keys drawn from
    counter 0 give another mask, and for the MFN head's time-major `out`
    site;
  * 2 ranks (one spawn, `tests/torch_parallel_ranks.py`) against the JAX
    `Engine(mesh=make_mesh(2))` from the same weights and dropout seeds, as
    tests/test_parallel.py holds that Engine to one device: a B2-Trans A+L
    `train_epoch` with dropout (parameters rtol 1e-3, atol 5e-5, but for
    the few elements Adam's eps leaves to float32 noise, see NOISE_ULPS;
    the epoch loss rel 1e-3), then `evaluate_per_video` and
    `evaluate_batched` (CCCs rtol 1e-3, atol 1e-4); an MFT A+L epoch of batches of 5 videos, so each
    batch has a pad row and the MFN head's time-major `out` site indexes a
    global batch of 6 rows; a `train_epoch_resident` of a B2-Trans A split
    of 5 videos; each of the three again on the threefry stream
    (`Engine(..., dropout_impl="threefry")` against the JAX mesh Engine
    under `set_dropout_impl("threefry")`; the B2-Trans epoch over 8
    videos, two full batches); an MFT A+L epoch at T = 8 on the "hash4"
    stream (`Engine(..., dropout_impl="hash4")` against the JAX mesh Engine
    under `set_dropout_impl("hash4")`: multi-bit sites shifted by their
    counters per row); a B2-Trans A+L epoch under rbg keys on the hash
    stream (`prng_impl="rbg"`, the JAX side under
    `jax_default_prng_impl="rbg"`: only the key tree changes); every rank
    ends with the same parameters; the negative controls (seeds not shifted to the rank's
    rows, or the `out` site indexed by the rank's own rows), on both
    streams, fail the same comparison;
  * tensor parallelism on a 2 x 2 ("data", "model") mesh (one spawn of 4
    ranks): each rank's parameter shards equal the JAX `shard_params_tp`
    shards on the same mesh position, and the eval forward of B2-Trans A+L
    ("query" mode, as tests/test_parallel.py; and "key_query", through
    kernel 11's route) and of MFT A+L ("key_query") equals the JAX
    single-device `apply` (rtol 1e-4, atol 1e-5);
  * `make_mesh(device_type="cuda")` raises without a card.

The JAX side runs in this process while the ranks run (they never import
jax); the dropout seeds of every step come from the JAX Engine's keys.
"""

import contextlib
import multiprocessing
import threading
from concurrent.futures import ProcessPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from make_goldens import SMALL_DIMS

import torch_parallel_ranks as ranks
from multimodal_transformer_tpu.data.batching import \
    make_batches as jmake_batches
from multimodal_transformer_tpu.engine import train_engine as jtrain_engine
from multimodal_transformer_tpu.engine.optim import \
    select_adam as jselect_adam
from multimodal_transformer_tpu.models import build_model as jbuild_model
from multimodal_transformer_tpu.models import default_config as jdefault_config
from multimodal_transformer_tpu.ops import basic as jbasic
from multimodal_transformer_tpu.parallel import make_mesh as jmake_mesh
from multimodal_transformer_tpu.parallel import pad_batch_rows as jpad_rows
from multimodal_transformer_tpu.parallel.tp import (make_mesh_2d as
                                                    jmake_mesh_2d)
from multimodal_transformer_tpu.parallel.tp import \
    shard_params_tp as jshard_params_tp
from multimodal_transformer_tpu_torch import build_model
from multimodal_transformer_tpu_torch.ops import mfn_core
from multimodal_transformer_tpu_torch.ops.basic import dropout, hash_keep_mask
from multimodal_transformer_tpu_torch.ops.seeds import DropoutSeeds
from multimodal_transformer_tpu_torch.utils import prng
from multimodal_transformer_tpu_torch.parallel import (make_mesh,
                                                       pad_batch_rows, spawn)
from multimodal_transformer_tpu_torch.utils.params import (export_params,
                                                           flatten_tree)
from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401

AL = ("acoustic", "linguistic")
RANKS = 2
LR = 1e-3
PARAM_RTOL, PARAM_ATOL = 1e-3, 5e-5
# Adam's update is lr * m_hat / (sqrt(v_hat) + eps), eps = 1e-8.  Where an
# element's sqrt(v_hat) (over g + wd * w) is near eps, a gradient error d
# moves the update by lr * eps * d / (sqrt(v_hat) + eps)**2, up to 1e5 * d:
# float32 rounding then decides the element.  At seed 3, B2-Trans A+L's
# layers.2 linears.3 has an element with g + wd * w = -1.5e-9 (JAX) and
# -0.4e-9 (port) at the first step, and the two weights end 9.5e-5 apart
# after the epoch, in one process as over 2 ranks.  The rule, on the JAX
# reference's gradients: at some step, that move exceeds PARAM_ATOL for
# d = NOISE_ULPS float32 eps of the tensor's largest gradient (the two
# packages' first-step gradients differ by at most 26 such eps on any
# B2-Trans A+L tensor with gradients above 1e-6, seeds 3 and 5).  Those
# elements are held to NOISE_STEP_BOUND * lr a step instead: Adam moves
# an element by about lr a step at most.
F32_EPS = float(np.finfo(np.float32).eps)
NOISE_ULPS = 32
NOISE_STEP_BOUND = 2.1
NOISE_MAX_SHARE = 1e-3
CCC_RTOL, CCC_ATOL = 1e-3, 1e-4
POOL = 3  # processes running the JAX side beside this one
TP_RTOL, TP_ATOL = 1e-4, 1e-5


@pytest.mark.parametrize("rows,multiple", [(5, 2), (6, 2), (5, 4), (1, 3)])
def test_pad_batch_rows_matches_jax(rows, multiple):
    a = np.arange(rows * 6, dtype=np.float32).reshape(rows, 2, 3) + 1
    got, want = pad_batch_rows(a, multiple), jpad_rows(a, multiple)
    assert got.shape == want.shape and got.shape[0] % multiple == 0
    np.testing.assert_array_equal(got, want)


# ----------------------------------------------------- seeds shifted to rows

SITE_B, SITE_T = 5, 3


def _site_table(impl: str = "hash"):
    """site -> (seed, per-row elements) at T = SITE_T, from the sites of an
    MFT A+L (front ends, encoders, gamma hiddens), an SFT A+L (embed) and
    a B1-LSTM A+L (decoder); impl "threefry" keeps the keys."""
    out = {}
    for i, family in enumerate(("MFT", "SFT", "B1-LSTM")):
        cfg = ranks.config({"family": family, "mods": AL,
                            "mask_mode": "key_query", "dims": SMALL_DIMS})
        sites = build_model(cfg).dropout_sites()
        seeds = DropoutSeeds.from_key(sites, prng.key(i), SITE_T, impl)
        out[family] = (sites, seeds)
    return out


def _per_row(site: str, sites, T: int, value=int):
    """(getter of the site's seed from DropoutSeeds, elements per row);
    value: applied to a table's entry (int for a hash seed)."""
    if site.startswith("front_"):
        i = int(site[-1])
        m = sites.front[i]
        return (lambda s: s.front[m]), T * sites.front_widths[i]
    if site.startswith("encoder_"):
        col = int(site[-1])
        d, f, h = sites.encoder_dims[0]
        name = sites.encoders[0]
        return ((lambda s: value(s.encoder[name][2][col])),
                (h * T * T, T * d, T * f, T * d)[col])
    if site.startswith("gamma_"):
        col = int(site[-1])
        return (lambda s: value(s.mfn[1][col])), sites.gamma_widths[col]
    return (lambda s: getattr(s, site)), T * getattr(sites, f"{site}_width")


SITES = [("MFT", "front_0"), ("MFT", "front_1"), ("MFT", "encoder_0"),
         ("MFT", "encoder_1"), ("MFT", "encoder_2"), ("MFT", "encoder_3"),
         ("MFT", "gamma_0"), ("MFT", "gamma_1"), ("SFT", "embed"),
         ("B1-LSTM", "embed"), ("B1-LSTM", "decoder")]


@pytest.mark.parametrize("family,site", SITES)
def test_for_rows_gives_the_global_mask_at_the_rank_rows(family, site):
    sites, seeds = _site_table()[family]
    get, per_row = _per_row(site, sites, SITE_T)
    rows = SITE_B + SITE_B % RANKS
    local = rows // RANKS
    glob = hash_keep_mask(get(seeds),
                          torch.arange(rows * per_row).view(rows, per_row),
                          0.5)
    for r in range(RANKS):
        shifted = seeds.for_rows(sites, r * local, rows, SITE_T)
        assert shifted.rows == (r * local, rows)
        idx = torch.arange(local * per_row).view(local, per_row)
        mine = hash_keep_mask(get(shifted), idx, 0.5)
        assert torch.equal(mine, glob[r * local:(r + 1) * local])
        if r > 0:  # the negative control: the unshifted seed's mask differs
            assert not torch.equal(hash_keep_mask(get(seeds), idx, 0.5),
                                   glob[r * local:(r + 1) * local])


@pytest.mark.parametrize("family,site", SITES)
def test_for_rows_gives_the_global_threefry_mask_at_the_rank_rows(family,
                                                                  site):
    """The rank's keys draw its rows of the global (padded) batch's
    `bernoulli` through `dropout`, as one range of counters."""
    sites, seeds = _site_table("threefry")[family]
    get, per_row = _per_row(site, sites, SITE_T, value=lambda k: k)
    rows = SITE_B + SITE_B % RANKS
    local = rows // RANKS
    glob = prng.bernoulli(get(seeds), 0.5, (rows, per_row), "cpu")
    ones = torch.ones(local, per_row)
    for r in range(RANKS):
        shifted = seeds.for_rows(sites, r * local, rows, SITE_T)
        assert shifted.rows == (r * local, rows)
        key = get(shifted)
        assert isinstance(key, prng.RowKeys) and key.r0 == r * local
        mine = dropout(ones, key, 0.5) != 0
        assert torch.equal(mine, glob[r * local:(r + 1) * local])
        if r > 0:  # the negative control: counters from 0 give another mask
            assert not torch.equal(dropout(ones, get(seeds), 0.5) != 0,
                                   glob[r * local:(r + 1) * local])


def test_threefry_gamma_masks_of_a_rank_are_the_global_masks():
    """mfn_core.gamma_masks with a rank's [T, 2] RowKeys table: each step's
    two [local, 64] masks are the global batch's at the rank's rows."""
    sites, seeds = _site_table("threefry")["MFT"]
    cfg = ranks.config({"family": "MFT", "mods": AL, "mask_mode": "key_query",
                        "dims": SMALL_DIMS})
    mfn = build_model(cfg, device="meta").Transformer.mfn
    rows, local = 6, 3
    glob = mfn_core.gamma_masks(mfn, seeds.mfn, torch.empty(rows, SITE_T))
    for r0 in (0, local):
        mine = mfn_core.gamma_masks(
            mfn, seeds.for_rows(sites, r0, rows, SITE_T).mfn,
            torch.empty(local, SITE_T))
        assert torch.equal(mine, glob[:, :, r0:r0 + local])
    assert not torch.equal(mfn_core.gamma_masks(mfn, seeds.mfn, torch.empty(
        local, SITE_T)), glob[:, :, local:])


def _head_inputs(rows: int, T: int):
    cfg = ranks.config({"family": "MFT", "mods": AL, "mask_mode": "key_query",
                        "dims": SMALL_DIMS})
    mfn = build_model(cfg, seed=1).Transformer.mfn
    rs = np.random.RandomState(0)
    total_h = mfn.out_fc1.in_features - mfn_core.MEM_DIM
    hs = torch.from_numpy(rs.randn(rows, T, total_h).astype(np.float32))
    mems = torch.from_numpy(rs.randn(rows, T, mfn_core.MEM_DIM).astype(
        np.float32))
    return mfn, hs, mems


def test_mfn_head_out_site_indexes_the_global_batch():
    rows, local, T = 6, 3, 4
    mfn, hs, mems = _head_inputs(rows, T)
    with torch.no_grad():
        want = mfn_core.mfn_head(mfn, hs, mems, out_seed=123)
        for r0 in (0, local):
            got = mfn_core.mfn_head(mfn, hs[r0:r0 + local],
                                    mems[r0:r0 + local], 123, (r0, rows))
            torch.testing.assert_close(got, want[r0:r0 + local], rtol=0,
                                       atol=0)
        own = mfn_core.mfn_head(mfn, hs[local:], mems[local:], 123)
    assert not torch.equal(own, want[local:])


def test_mfn_head_threefry_out_site_draws_the_rank_segments():
    """The threefry `out` key over a rank's rows draws T segments of the
    global time-major [T, rows, 64] draw; drawn over the rank's own rows
    (counters from 0, one segment) it gives another mask, on either
    rank."""
    rows, local, T = 6, 3, 4
    mfn, hs, mems = _head_inputs(rows, T)
    key = prng.fold_in(prng.key(123), 7)
    with torch.no_grad():
        want = mfn_core.mfn_head(mfn, hs, mems, out_seed=key)
        for r0 in (0, local):
            part = slice(r0, r0 + local)
            got = mfn_core.mfn_head(mfn, hs[part], mems[part], key,
                                    (r0, rows))
            torch.testing.assert_close(got, want[part], rtol=0, atol=0)
            own = mfn_core.mfn_head(mfn, hs[part], mems[part], key)
            assert not torch.equal(own, want[part])


# ----------------------------------------------------------- data parallel

def _data(mods, V, T, lens, seed):
    rs = np.random.RandomState(seed)
    x = {m: rs.randn(V, T, 3, SMALL_DIMS[m]).astype(np.float32) for m in mods}
    y = rs.rand(V, T).astype(np.float32)
    return x, y


def _case(family, mods, *, V, T, lens, batch_size, kind="epoch", seed=3,
          evaluate=False, pad_time_to=None, impl="hash", prng="threefry"):
    x, y = _data(mods, V, T, lens, seed)
    return dict(family=family, mods=mods, mask_mode="key_query",
                dims=SMALL_DIMS, seed=seed, x=x, y=y, lens=lens,
                batch_size=batch_size, shuffle_seed=9, kind=kind,
                evaluate=evaluate, pad_time_to=pad_time_to, key=seed + 2,
                impl=impl, prng=prng)


@contextlib.contextmanager
def _jax_keys(prng_impl: str):
    """JAX's keys under the case's key implementation ("threefry" or
    "rbg"), the default restored after."""
    old = jax.config.jax_default_prng_impl
    if prng_impl == "rbg":
        jax.config.update("jax_default_prng_impl", "rbg")
    try:
        yield
    finally:
        jax.config.update("jax_default_prng_impl", old)


def _cases(impl: str, suffix: str = "") -> dict:
    hash_ = impl == "hash"
    return {
        # tests/test_parallel.py:110, over 2 ranks, every batch at T = 8;
        # the evaluations on the hash case; on the threefry stream two full
        # batches (one JAX compile of the step, not two)
        "b2" + suffix: _case("B2-Trans", AL, V=6 if hash_ else 8, T=8,
                             lens=[8, 8, 7, 6, 8, 5] + ([] if hash_
                                                        else [7, 8]),
                             batch_size=4, evaluate=hash_, pad_time_to=8,
                             impl=impl),
        # batches of 5: a pad row each, the `out` site at B_pad = 6
        "mft" + suffix: _case("MFT", AL, V=10, T=6,
                              lens=[6, 5, 6, 4, 6, 6, 3, 6, 2, 5],
                              batch_size=5, pad_time_to=6, impl=impl),
        # tests/test_parallel.py:179, V = 5 over 2 ranks
        "resident" + suffix: _case("B2-Trans", ("acoustic",), V=5, T=5,
                                   lens=[5, 5, 4, 3, 2], batch_size=4,
                                   kind="resident", impl=impl),
    }


# the hash stream's cases, then the threefry stream's (kernel T's masks on
# the card; its plain version here); an MFT epoch at T = 8 (a multi-bit
# attention site) on the hash4 stream, batches of 5 with a pad row; a
# B2-Trans epoch under rbg keys
DP_CASES = {**_cases("hash"), **_cases("threefry", "_threefry"),
            "mft_hash4": _case("MFT", AL, V=10, T=8,
                               lens=[8, 5, 6, 4, 8, 7, 3, 8, 2, 5],
                               batch_size=5, pad_time_to=8, impl="hash4"),
            "b2_rbg": _case("B2-Trans", AL, V=6, T=8,
                            lens=[8, 8, 7, 6, 8, 5], batch_size=4,
                            pad_time_to=8, prng="rbg")}
CONTROLS = {"b2_unshifted": ("b2", "unshifted"),
            "mft_local_out": ("mft", "local_out"),
            "b2_threefry_unshifted": ("b2_threefry", "unshifted"),
            "mft_threefry_local_out": ("mft_threefry", "local_out")}


def _steps_T(case):
    """Each step's batch length, as both Engines' batches give it."""
    if case["kind"] == "resident":
        return [max(case["lens"])] * -(-len(case["lens"])
                                       // case["batch_size"])
    return [b.mask.shape[1] for b in jmake_batches(
        case["x"], case["y"], case["lens"], case["batch_size"], True,
        np.random.RandomState(case["shuffle_seed"]), case["pad_time_to"])]


def _jax_cfg(case):
    jcfg = jdefault_config(case["family"], case["mods"],
                           mask_mode=case["mask_mode"])
    object.__setattr__(jcfg, "mod_dimension", dict(SMALL_DIMS))
    return jcfg


def _noise_decided(steps: list, weight_decay: float) -> dict:
    """{parameter: the elements whose Adam update float32 noise in the
    gradient moves past PARAM_ATOL at some step}, from each step's
    (parameters, gradients) as flat trees."""
    b2, eps = 0.999, 1e-8  # engine/optim.py adam_update
    out = {}
    for k in steps[0][0]:
        v = np.zeros(steps[0][0][k].shape)
        hit = np.zeros(v.shape, bool)
        for t, (params, grads) in enumerate(steps, 1):
            g = grads[k].astype(np.float64) + weight_decay * params[k]
            v = b2 * v + (1 - b2) * g * g
            # a gradient of exactly 0 (a unit no input reached) is exact
            d = (NOISE_ULPS * F32_EPS * np.abs(grads[k]).max(initial=0)
                 * (grads[k] != 0))
            hit |= (LR * eps * d / (np.sqrt(v / (1 - b2 ** t)) + eps) ** 2
                    > PARAM_ATOL)
        out[k] = hit
    return out


def _recording_adam(steps: dict):
    """engine/optim.py select_adam whose update also hands each step's
    parameters and gradients to the host, into steps[step] (from 0)."""
    init, update, reconcile = jselect_adam()

    def record(step, params, grads):
        steps[int(step)] = tuple({k: np.array(v) for k, v in
                                  flatten_tree(t).items()}
                                 for t in (params, grads))

    def update_and_record(params, grads, state, lr, **kw):
        jax.debug.callback(record, state["step"], params, grads)
        return update(params, grads, state, lr, **kw)
    return lambda: (init, update_and_record, reconcile)


def _jax_mesh_engine(name: str, tree) -> dict:
    """The JAX Engine(mesh=make_mesh(2)) of DP_CASES[name], from the port's
    initial weights: its epoch loss, parameters, noise-decided elements
    and evaluations.  Runs in a process of its own (the module-scoped
    pool) or in the test's."""
    jax.config.update("jax_platforms", "cpu")
    case = DP_CASES[name]
    with _jax_keys(case["prng"]):
        return _jax_mesh_engine_epoch(case, tree)


def _jax_mesh_engine_epoch(case, tree) -> dict:
    key = jax.random.PRNGKey(case["key"])
    _, apply = jbuild_model(_jax_cfg(case))
    steps = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrain_engine, "build_model", lambda c: (
            lambda key: jax.tree_util.tree_map(jnp.asarray, tree), apply))
        mp.setattr(jtrain_engine, "select_adam", _recording_adam(steps))
        eng = jtrain_engine.Engine(_jax_cfg(case), lr=LR, seed=0,
                                   mesh=jmake_mesh(RANKS), nan_guard=False)
    out = {}
    jbasic.set_dropout_impl(case["impl"])
    try:
        if case["kind"] == "resident":
            st = eng.upload_dataset(case["x"], case["y"], case["lens"])
            out["loss"] = eng.train_epoch_resident(
                st, batch_size=case["batch_size"], rng=ranks.NoShuffle(),
                jax_rng=key)
        else:
            out["loss"] = eng.train_epoch(
                case["x"], case["y"], case["lens"],
                batch_size=case["batch_size"],
                rng=np.random.RandomState(case["shuffle_seed"]),
                jax_rng=key, pad_time_to=case["pad_time_to"])
    finally:
        jbasic.set_dropout_impl(None)
    out["params"] = {k: np.asarray(v)
                     for k, v in flatten_tree(eng.params).items()}
    assert sorted(steps) == list(range(len(_steps_T(case))))
    out["noise"] = _noise_decided([steps[t] for t in sorted(steps)],
                                  eng._wd)
    if case["evaluate"]:
        cccs, _, _, loss, _, _ = eng.evaluate_per_video(case["x"], case["y"],
                                                        case["lens"])
        out["per_video"] = (cccs, loss)
        cccs, loss, _ = eng.evaluate_batched(case["x"], case["y"],
                                             case["lens"], batch_size=4,
                                             time_multiple=4)
        out["batched"] = (cccs, loss)
    return out


def _run_ranks_in_thread(fn, nprocs, *args):
    """Start the ranks on a thread (the JAX side runs meanwhile); returns
    a function that joins it and gives the ranks' results."""
    box = {}

    def run():
        try:
            box["out"] = spawn(fn, nprocs, *args, device_type="cpu")
        except BaseException as e:  # raised again in the test
            box["err"] = e

    th = threading.Thread(target=run, daemon=True)
    th.start()

    def join():
        th.join(timeout=300)
        assert not th.is_alive(), "the ranks did not finish in 300 s"
        if "err" in box:
            raise box["err"]
        return box["out"]
    return join


def _params_close(got: dict, want: dict) -> bool:
    """Every element but the noise-decided ones within the limit."""
    return all(np.allclose(got[k].numpy()[~want["noise"][k]],
                           w[~want["noise"][k]], rtol=PARAM_RTOL,
                           atol=PARAM_ATOL)
               for k, w in want["params"].items())


@pytest.mark.parametrize("name", list(DP_CASES))
def test_dp_epoch_matches_jax_mesh_engine(dp_runs, name):
    want, got = dp_runs
    bound = NOISE_STEP_BOUND * LR * len(_steps_T(DP_CASES[name]))
    for rank in range(RANKS):
        res = got[rank][name]
        assert res["loss"] == pytest.approx(want[name]["loss"], rel=1e-3)
        for k, w in want[name]["params"].items():
            noise, p = want[name]["noise"][k], res["params"][k].numpy()
            np.testing.assert_allclose(p[~noise], w[~noise],
                                       rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                       err_msg=f"{name} rank {rank} {k}")
            assert np.abs(p[noise] - w[noise]).max(initial=0) <= bound, \
                f"{name} rank {rank} {k}"


@pytest.mark.parametrize("name", list(DP_CASES))
def test_dp_noise_decided_elements_are_few(dp_runs, name):
    """The rule leaves out no more than NOISE_MAX_SHARE of the elements
    (352, 796 and 266 of 2.5 M, 4.7 M and 2.2 M at seed 3)."""
    want, _ = dp_runs
    noise = want[name]["noise"]
    n = sum(int(m.sum()) for m in noise.values())
    total = sum(m.size for m in noise.values())
    assert n <= NOISE_MAX_SHARE * total, (name, n, total)


@pytest.mark.parametrize("name", list(DP_CASES) + list(CONTROLS))
def test_dp_ranks_end_equal(dp_runs, name):
    _, got = dp_runs
    first = got[0][name]["params"]
    for rank in range(1, RANKS):
        for k, v in got[rank][name]["params"].items():
            assert torch.equal(v, first[k]), f"{name} rank {rank} {k}"


@pytest.mark.parametrize("name", list(CONTROLS))
def test_dp_negative_controls_disagree_with_jax(dp_runs, name):
    want, got = dp_runs
    base = CONTROLS[name][0]
    assert _params_close(got[0][base]["params"], want[base])
    assert not _params_close(got[0][name]["params"], want[base])


@pytest.mark.parametrize("evaluation", ["per_video", "batched"])
def test_dp_evaluation_matches_jax_mesh_engine(dp_runs, evaluation):
    want, got = dp_runs
    w_cccs, w_loss = want["b2"][evaluation]
    assert len(w_cccs) == len(DP_CASES["b2"]["lens"])
    for rank in range(RANKS):
        cccs, loss = got[rank]["b2"][evaluation]
        np.testing.assert_allclose(cccs, w_cccs, rtol=CCC_RTOL,
                                   atol=CCC_ATOL)
        assert loss == pytest.approx(w_loss, rel=1e-3)


# ---------------------------------------------------------- tensor parallel

TP_DATA, TP_MODEL = 2, 2
TP_CASES = {
    "b2_query": ("B2-Trans", "query"),
    "b2_key_query": ("B2-Trans", "key_query"),
    "mft_key_query": ("MFT", "key_query"),
}


def _tp_case(family, mask_mode):
    rs = np.random.RandomState(2)
    B, T = 4, 6
    mask = np.ones((B, T, 1), np.float32)
    mask[3, 4:] = 0
    mask[1, 5:] = 0
    return dict(family=family, mods=AL, mask_mode=mask_mode,
                dims=SMALL_DIMS, seed=2, mask=mask,
                x={m: rs.randn(B, T, 3, SMALL_DIMS[m]).astype(np.float32)
                   for m in AL})


def _spec_axis(sharding):
    """The axis a JAX NamedSharding splits over "model" (None: replicated)."""
    spec = tuple(sharding.spec)
    return spec.index("model") if "model" in spec else None


def _jax_tp() -> dict:
    """{case: (the JAX single-device output, the JAX shard_params_tp shards
    by (data, model) position, the JAX layout)} of TP_CASES."""
    jax.config.update("jax_platforms", "cpu")
    want = {}
    mesh = jmake_mesh_2d(TP_DATA, TP_MODEL)
    pos = {d: i for i, d in enumerate(mesh.devices.ravel())}
    for name, case in _tp_cases().items():
        cfg = ranks.config(case)
        tree = export_params(build_model(cfg, seed=case["seed"]))
        _, apply = jbuild_model(_jax_cfg(case))
        params = jax.tree_util.tree_map(jnp.asarray, tree)
        out = np.asarray(jax.jit(lambda p, d, m: apply(p, d, m, rng=None))(
            params, {m: jnp.asarray(v) for m, v in case["x"].items()},
            jnp.asarray(case["mask"])))
        sharded, shardings = jshard_params_tp(params, mesh)
        shards = {}
        for k, arr in flatten_tree(sharded).items():
            for s in arr.addressable_shards:
                shards[(pos[s.device], k)] = np.asarray(s.data)
        layout = {k: _spec_axis(s) for k, s in flatten_tree(shardings).items()}
        want[name] = (out, shards, layout)
    return want


def _tp_cases() -> dict:
    return {name: _tp_case(*spec) for name, spec in TP_CASES.items()}


@pytest.fixture(scope="module")
def runs():
    """(DP: {case: the JAX mesh Engine's results} and [each rank's
    results], the negative controls' under their own names; TP: the JAX
    side and [each rank's results]).  Everything runs at once: both spawns
    of ranks, the first DP case's JAX Engine here, the other DP cases' and
    the TP JAX side in a pool of spawned processes."""
    jbasic.set_dropout_impl("hash")
    try:
        tp_join = _run_ranks_in_thread(ranks.tp_cases, TP_DATA * TP_MODEL,
                                       _tp_cases(), TP_DATA, TP_MODEL)
        trees = {name: export_params(build_model(
            ranks.config(case), seed=case["seed"], prng_impl=case["prng"]))
                 for name, case in DP_CASES.items()}
        first, *rest = DP_CASES
        # the longest JAX compiles first (the MFT steps, the threefry
        # steps), over POOL processes
        rest.sort(key=lambda n: (not n.startswith("mft"),
                                 DP_CASES[n]["impl"] == "hash"))
        with ProcessPoolExecutor(
                POOL, mp_context=multiprocessing.get_context("spawn")
                ) as pool:
            futures = {name: pool.submit(_jax_mesh_engine, name, trees[name])
                       for name in rest}
            tp_future = pool.submit(_jax_tp)
            rank_cases = {}
            for name, case in DP_CASES.items():
                cfg = ranks.config(case)
                sites = build_model(cfg, device="meta").dropout_sites()
                with _jax_keys(case["prng"]):
                    key = jax.random.PRNGKey(case["key"])
                    rank_cases[name] = dict(case, seeds=[
                        DropoutSeeds.from_key(sites, np.asarray(
                            jax.random.key_data(jax.random.fold_in(key, i))),
                            T, case["impl"])
                        for i, T in enumerate(_steps_T(case))])
            for name, (base, control) in CONTROLS.items():
                rank_cases[name] = dict(rank_cases[base], evaluate=False,
                                        control=control)
            dp_join = _run_ranks_in_thread(ranks.dp_cases, RANKS, rank_cases)
            dp_want = {first: _jax_mesh_engine(first, trees[first])}
            dp_want.update({name: f.result(timeout=300)
                            for name, f in futures.items()})
            tp_want = tp_future.result(timeout=300)
        return (dp_want, dp_join()), (tp_want, tp_join())
    finally:
        jbasic.set_dropout_impl(None)


@pytest.fixture(scope="module")
def dp_runs(runs):
    return runs[0]


@pytest.fixture(scope="module")
def tp_runs(runs):
    return runs[1]


@pytest.mark.parametrize("name", list(TP_CASES))
def test_tp_forward_matches_jax(tp_runs, name):
    want, got = tp_runs
    out = want[name][0]
    per_data = out.shape[0] // TP_DATA
    for rank in range(TP_DATA * TP_MODEL):
        res = got[rank][name]
        r0 = res["r0"]
        assert r0 == (rank // TP_MODEL) * per_data
        np.testing.assert_allclose(res["pred"].numpy(),
                                   out[r0:r0 + per_data], rtol=TP_RTOL,
                                   atol=TP_ATOL, err_msg=f"rank {rank}")


@pytest.mark.parametrize("name", list(TP_CASES))
def test_tp_shards_equal_jax_shard_params_tp(tp_runs, name):
    want, got = tp_runs
    _, shards, layout = want[name]
    assert any(ax is not None for ax in layout.values())
    for rank in range(TP_DATA * TP_MODEL):
        res = got[rank][name]
        assert res["layout"] == layout
        for k, v in res["params"].items():
            assert np.array_equal(v.numpy(), shards[(rank, k)]), (rank, k)


def test_make_mesh_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(device_type="cuda")
