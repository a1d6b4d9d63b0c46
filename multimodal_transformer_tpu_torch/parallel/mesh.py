"""Data parallelism over torch.distributed: one process per rank.

Counterpart of `multimodal_transformer_tpu/parallel/mesh.py`.  The JAX
package replicates the parameters and shards each batch's rows over a 1-D
mesh named "data"; GSPMD partitions one global program, so its dropout
masks are those of the global (padded) batch.  Here every rank builds the
same global batch from the same host RNG and keeps its own contiguous rows
(`shard_batch`); its dropout seeds are shifted to those rows
(`DropoutSeeds.for_rows`, ops/seeds.py: a hash seed shifted, threefry keys
drawing the rows' range of counters, from the `Shard`'s r0 and rows on
either stream), the gradients are summed with one
`all_reduce` of a flat buffer kept from step to step (`all_reduce_flat`,
`FlatBuffer`), and the parameters start
equal from the same seed and a broadcast from the mesh's first rank
(`broadcast_flat`).

Backends: NCCL where each rank has its own card, gloo on the CPU and where
ranks share one card (gloo carries `all_reduce` and `broadcast` of CUDA
tensors).  `spawn` starts the ranks in processes of their own, as the tests
do; `torchrun` does the same from the shell (see README).
"""

from __future__ import annotations

import dataclasses
import datetime
import tempfile
from pathlib import Path
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..data.batching import Batch

TIMEOUT = datetime.timedelta(minutes=5)


def make_mesh(n: Optional[int] = None, device_type: str = "cuda") -> DeviceMesh:
    """A 1-D mesh named ("data",) over the first n ranks of the initialised
    process group (all of them when n is None).  Raises without a card for
    device_type "cuda": it never goes to the CPU on its own."""
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh(device_type='cuda'): no CUDA device; "
                           "pass device_type='cpu' for a CPU mesh")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: initialise the process group first "
                           "(torchrun, or parallel.spawn)")
    n = dist.get_world_size() if n is None else n
    return init_device_mesh(device_type, (n,), mesh_dim_names=("data",))


def pad_batch_rows(arr: np.ndarray, multiple: int) -> np.ndarray:
    """Zero-pad the batch axis up to a multiple of the mesh size.  Padded
    rows carry an all-zero mask, so they add nothing to loss or metrics."""
    rem = (-arr.shape[0]) % multiple
    if rem == 0:
        return arr
    return np.pad(arr, [(0, rem)] + [(0, 0)] * (arr.ndim - 1))


@dataclasses.dataclass
class Shard(Batch):
    """One rank's rows [r0, r0 + local) of a global batch padded to `rows`
    rows; `lengths` and `indices` cover its real rows only (they come
    first), `total` is the global batch's sum of lengths (the loss's
    denominator).  The time axis is the global batch's."""
    r0: int = 0
    rows: int = 0
    total: int = 0


def _rows(a, lo: int, hi: int, count: int):
    """Rows [lo, hi) of a, zero rows appended up to count rows (numpy array
    or tensor)."""
    part = a[lo:hi]
    short = count - part.shape[0]
    if short == 0:
        return part
    if isinstance(part, np.ndarray):
        return np.pad(part, [(0, short)] + [(0, 0)] * (part.ndim - 1))
    pad = part.new_zeros((short, *part.shape[1:]))
    return torch.cat([part, pad])


def shard_rows(n_rows: int, mesh: DeviceMesh):
    """(r0, local, rows): this rank's first row and row count in a batch of
    n_rows padded to `rows`, a multiple of the mesh size."""
    n = mesh.size()
    rows = n_rows + (-n_rows) % n
    local = rows // n
    return mesh.get_local_rank() * local, local, rows


def shard_batch(batch: Batch, mesh: DeviceMesh) -> Shard:
    """This rank's contiguous rows of the global batch, padded to a
    multiple of the mesh size (pad rows zero, length 0), at the global
    batch's time length.  The arrays may be numpy arrays or tensors."""
    r0, local, rows = shard_rows(batch.mask.shape[0], mesh)
    hi = r0 + local
    cut = lambda a: _rows(a, r0, hi, local)
    return Shard({m: cut(v) for m, v in batch.data.items()},
                 cut(batch.target), cut(batch.mask),
                 list(batch.lengths[r0:hi]),
                 None if batch.indices is None else list(batch.indices[r0:hi]),
                 r0=r0, rows=rows, total=int(sum(batch.lengths)))


class FlatBuffer:
    """One flat buffer, kept from call to call, for a list of tensors of
    one dtype and device: the tensors are copied in, a collective acts on
    the buffer, and the result is copied back (one multi-tensor copy each
    way; the buffer is made again only when the tensors' shapes change)."""

    def __init__(self):
        self.flat: Optional[torch.Tensor] = None
        self._views: List[torch.Tensor] = []
        self._shapes: list = []

    def __call__(self, tensors: Sequence[torch.Tensor], collective) -> None:
        tensors = list(tensors)
        shapes = [t.shape for t in tensors]
        if shapes != self._shapes:
            self.flat = tensors[0].new_empty(sum(t.numel() for t in tensors))
            self._views = [part.view(t.shape) for t, part in zip(
                tensors, self.flat.split([t.numel() for t in tensors]))]
            self._shapes = shapes
        with torch.no_grad():
            torch._foreach_copy_(self._views, tensors)
            collective(self.flat)
            torch._foreach_copy_(tensors, self._views)


def broadcast_flat(tensors: Sequence[torch.Tensor], mesh: DeviceMesh) -> None:
    """Overwrite the tensors with the mesh's first rank's, one broadcast of
    a flat buffer."""
    src = dist.get_global_rank(mesh.get_group(), 0)
    FlatBuffer()(tensors, lambda flat: dist.broadcast(
        flat, src=src, group=mesh.get_group()))


def all_reduce_flat(tensors: Sequence[torch.Tensor], mesh: DeviceMesh,
                    buffer: FlatBuffer) -> None:
    """Sum the tensors over the mesh in place, one all_reduce of buffer."""
    buffer(tensors, lambda flat: dist.all_reduce(flat,
                                                 group=mesh.get_group()))


def gather_objects(obj, mesh: DeviceMesh) -> list:
    """Every rank's obj, in rank order, on every rank."""
    out = [None] * mesh.size()
    dist.all_gather_object(out, obj, group=mesh.get_group())
    return out


def barrier(mesh: DeviceMesh) -> None:
    dist.barrier(group=mesh.get_group())


def default_backend(device_type: str, nprocs: int) -> str:
    """NCCL where every rank has a card of its own, else gloo."""
    if device_type == "cuda" and torch.cuda.device_count() >= nprocs:
        return "nccl"
    return "gloo"


def _rank_main(rank: int, fn: Callable, args: tuple, nprocs: int,
               workdir: str, device_type: str) -> None:
    if device_type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(default_backend(device_type, nprocs),
                            init_method=f"file://{workdir}/store",
                            world_size=nprocs, rank=rank, timeout=TIMEOUT)
    try:
        result = fn(rank, *args)
        torch.save(result, Path(workdir) / f"result{rank}.pt")
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, nprocs: int, *args, device_type: str = "cuda",
          workdir: Optional[str] = None) -> List:
    """Run fn(rank, *args) in nprocs fresh processes joined by a process
    group (a FileStore in workdir, a new temporary directory when None) and
    return their results in rank order.  fn must be importable by name and
    return something torch.save can write (tensors on the CPU).  A rank's
    exception ends the other ranks and is raised here.  For device_type
    "cuda" rank r runs on card r % device_count, over NCCL when every rank
    has a card of its own, else over gloo."""
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        torch.multiprocessing.spawn(
            _rank_main, args=(fn, args, nprocs, tmp, device_type),
            nprocs=nprocs, join=True)
        return [torch.load(Path(tmp) / f"result{r}.pt", weights_only=False)
                for r in range(nprocs)]
