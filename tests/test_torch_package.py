"""Shape of the PyTorch port and its gate on the card: no JAX or host-only
imports, parameter names shared with the JAX tree, the re-homed bucketing,
and chip_smoke.py refusing to run without a CUDA device."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from multimodal_transformer_tpu.data.batching import \
    bucketed_eval_batches as jbucketed
from multimodal_transformer_tpu.models import build_model as jbuild_model
from multimodal_transformer_tpu.models import default_config as jdefault_config
from multimodal_transformer_tpu_torch import build_model, default_config
from multimodal_transformer_tpu_torch.data import bucketed_eval_batches
from multimodal_transformer_tpu_torch.ops.cuda import _build
from multimodal_transformer_tpu_torch.utils.params import flatten_tree

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "multimodal_transformer_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "pandas", "msgpack", "matplotlib",
             "multimodal_transformer_tpu"}


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(REPO)) for p in PORT.rglob("*.py")]
    + ["chip_smoke.py"]))
def test_no_forbidden_imports(path):
    bad = set(_imported_roots(REPO / path)) & FORBIDDEN
    assert not bad, f"{path} imports {sorted(bad)}"


def _mods(comb):
    return tuple(m for m, c in (("acoustic", "A"), ("image", "V"),
                                ("linguistic", "L")) if c in comb)


@pytest.mark.parametrize("comb", ["AVL", "AL", "VL", "AV"])
def test_state_dict_keys_equal_jax_tree(comb):
    mods = _mods(comb)
    jinit, _ = jbuild_model(jdefault_config("MFT", mods))
    shapes = jax.eval_shape(jinit, jax.random.PRNGKey(0))
    want = {k: tuple(v.shape) for k, v in flatten_tree(shapes).items()}
    got = {k: tuple(v.shape) for k, v in
           build_model(default_config("MFT", mods)).state_dict().items()}
    assert got == want


@pytest.mark.parametrize("family,comb,variant", [
    ("MFT", "L", "default"), ("SFT", "AVL", "default"),
    ("SFT", "V", "default"), ("B1-LSTM", "AVL", "default"),
    ("B1-LSTM", "L", "legacy"), ("B2-Trans", "AVL", "default"),
    ("B3-MFN", "AVL", "default"), ("B3-MFN", "A", "default")])
def test_family_state_dict_keys_equal_jax_tree(family, comb, variant):
    """Every family at its full default widths (the chip_smoke.py serving
    configurations among them)."""
    mods = _mods(comb)
    jinit, _ = jbuild_model(jdefault_config(family, mods, variant=variant))
    shapes = jax.eval_shape(jinit, jax.random.PRNGKey(0))
    want = {k: tuple(v.shape) for k, v in flatten_tree(shapes).items()}
    got = {k: tuple(v.shape) for k, v in build_model(default_config(
        family, mods, variant=variant)).state_dict().items()}
    assert got == want


def test_other_families_raise_not_implemented():
    """Every family trains: a training forward (dropout seeds for the
    module's own sites) runs on the CPU and gives finite predictions of the
    mask's shape for every configuration the JAX `build_model` accepts; a
    configuration it refuses (an unknown family) still raises."""
    import dataclasses

    from multimodal_transformer_tpu.models.families import FAMILY_FNS
    from multimodal_transformer_tpu_torch.ops.seeds import DropoutSeeds

    for family, mods, variant in (
            ("SFT", ("image", "linguistic"), "default"),
            ("SFT", ("acoustic",), "default"),
            ("B3-MFN", ("acoustic", "linguistic"), "default"),
            ("B3-MFN", ("image",), "default"),
            ("B2-Trans", ("acoustic", "image", "linguistic"), "default"),
            ("B1-LSTM", ("image", "linguistic"), "default"),
            ("B1-LSTM", ("linguistic",), "legacy"),
            ("MFT", ("linguistic",), "default"),
            ("MFT", ("acoustic", "image"), "default")):
        assert family in FAMILY_FNS
        cfg = default_config(family, mods, variant=variant)
        module = build_model(cfg)
        inputs = {m: torch.randn(1, 3, 4, cfg.mod_dimension[m]) for m in mods}
        seeds = DropoutSeeds.draw(module.dropout_sites(), 3,
                                  torch.Generator().manual_seed(0))
        pred = module(inputs, torch.ones(1, 3, 1), seeds=seeds)
        assert pred.shape == (1, 3, 1) and bool(torch.isfinite(pred).all())
    bad = dataclasses.replace(default_config("SFT", ("linguistic",)),
                              family="B4-GRU")
    assert bad.family not in FAMILY_FNS
    with pytest.raises(ValueError, match="unknown family"):
        build_model(bad)


@pytest.mark.parametrize("batch_size,time_multiple", [(4, 8), (32, 32), (3, 5)])
def test_bucketed_batches_match_jax(batch_size, time_multiple):
    rs = np.random.RandomState(0)
    lens = [3, 8, 5, 11, 14, 7, 1, 0, 12]
    data = {"a": rs.randn(9, 14, 2, 3).astype(np.float32),
            "b": rs.randn(9, 14, 4, 5).astype(np.float32)}
    target = rs.randn(9, 14).astype(np.float32)
    got = list(bucketed_eval_batches(data, target, lens, batch_size,
                                     time_multiple))
    want = list(jbucketed(data, target, lens, batch_size, time_multiple))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.lengths == w.lengths and g.indices == w.indices
        np.testing.assert_array_equal(g.mask, w.mask)
        np.testing.assert_array_equal(g.target, w.target)
        for m in data:
            np.testing.assert_array_equal(g.data[m], w.data[m])


def test_import_builds_nothing():
    code = ("import multimodal_transformer_tpu_torch as p, sys; "
            "from multimodal_transformer_tpu_torch.ops.cuda import _build; "
            "assert _build._lib is None; "
            "assert not any(m.split('.')[0] in ('jax', 'pandas', 'flax') "
            "for m in sys.modules), sorted(sys.modules)")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_library_name_follows_the_sources():
    p = _build.library_path()
    assert p.parent == _build.BUILD_DIR and p.name.startswith("libmmtx_")
    assert {s.name for s in _build.sources()} == {
        "encoder.cu", "mfn.cu", "encoder_train.cu", "encoder_bwd.cu",
        "mfn_train.cu", "window_embed.cu", "flash_attention.cu",
        "mfn_variants.cu"}


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_refuses_without_cuda(where, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py runs for real")
    cwd = REPO
    if where == "alone":
        shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
