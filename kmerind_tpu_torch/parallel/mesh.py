"""The shard layout of an index: how many shards, on which ranks.

The port of ``kmerind_tpu.parallel.mesh``.  The JAX package spreads an
index's shards over a `jax.sharding.Mesh` of devices, possibly on many
processes; here a `Mesh` names the shards and the `torch.distributed`
process group that holds them.  Rank r of W holds the global shards
[r * p_local, (r + 1) * p_local) stacked [p_local, ...] on its own
`device`; the exchanges between ranks are collectives of the group
(``parallel/distribute.py``).  One process with no group is `world` 1 and
holds every shard, the layout every index had before meshes.

The collectives an index needs between its device steps are methods here:
the all-reduced max / sum of a host int (every rank must then take the
same branch), the all-gather of equal tensors and of ragged row sets, and
the all-to-all of the bucket exchange.  Under the gloo backend, which has
no collectives for CUDA tensors, each stages its tensors through host
memory; under NCCL they stay on the device.  Every method is a collective
when `world` > 1: each rank must call it, in the same order.

The JAX module's `axes_of` and `shard_axis_sharding` name mesh axes for
XLA's sharding annotations; a `torch.distributed` group has no axes, so
they have no counterpart.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as tdist

__all__ = ["Mesh", "as_mesh", "make_mesh", "make_mesh_2d"]


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """`nparts` shards over the `world` ranks of the default group,
    `nparts // world` on each, this rank's on `device`.  `shape` is the (hosts, shards per host)
    layout of `make_mesh_2d`, else (nparts,); shard g lives on rank
    g // p_local either way."""

    nparts: int
    device: torch.device | None = None
    world: int = 1
    rank: int = 0
    backend: str | None = None
    shape: tuple = ()

    def __post_init__(self):
        if self.nparts < 1 or self.nparts % self.world:
            raise ValueError(f"{self.nparts} shards do not split over "
                             f"{self.world} ranks")
        if not self.shape:
            object.__setattr__(self, "shape", (self.nparts,))

    @property
    def p_local(self) -> int:
        """Shards on this rank."""
        return self.nparts // self.world

    @property
    def shard_range(self) -> tuple[int, int]:
        """[first, last) global shard of this rank."""
        return self.rank * self.p_local, (self.rank + 1) * self.p_local

    # -- collectives (identity with one rank) -------------------------------
    def _comm(self, t: torch.Tensor) -> torch.Tensor:
        """`t` where the backend can reach it: host memory under gloo, the
        rank's device under NCCL."""
        if self.backend == "nccl":
            return t.to(self.device)
        return t.cpu()

    def _reduce_int(self, x: int, op) -> int:
        if self.world == 1:
            return int(x)
        t = self._comm(torch.tensor([int(x)], dtype=torch.int64))
        tdist.all_reduce(t, op=op)
        return int(t.item())

    def all_max(self, x: int) -> int:
        """The largest of every rank's host int."""
        return self._reduce_int(x, tdist.ReduceOp.MAX)

    def all_sum(self, x: int) -> int:
        """The sum of every rank's host int."""
        return self._reduce_int(x, tdist.ReduceOp.SUM)

    def all_sum_tensor(self, t: torch.Tensor) -> torch.Tensor:
        """Elementwise sum of every rank's tensor (same shape on all), on
        t's device."""
        if self.world == 1:
            return t
        c = self._comm(t.clone())
        tdist.all_reduce(c)
        return c.to(t.device)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's tensor (same shape on all) concatenated along dim 0
        in rank order, on t's device."""
        if self.world == 1:
            return t
        src = self._comm(_wire(t).contiguous())
        out = [torch.empty_like(src) for _ in range(self.world)]
        tdist.all_gather(out, src)
        return _unwire(torch.cat(out), t.dtype).to(t.device)

    def all_gather_ragged(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's rows t[n_r, ...] (n_r may differ; the trailing shape
        may not) concatenated in rank order, on t's device."""
        if self.world == 1:
            return t
        sizes = self.all_gather(torch.tensor([t.shape[0]], dtype=torch.int64))
        pad = int(sizes.max())
        full = torch.cat([t, t.new_zeros((pad - t.shape[0],) + t.shape[1:])])
        out = self.all_gather(full).reshape((self.world, pad) + t.shape[1:])
        return torch.cat([out[r, :n] for r, n in enumerate(sizes.tolist())])

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """t[W, ...]: slab r goes to rank r; returns [W, ...], slab r from
        rank r (torch.distributed.all_to_all_single), on t's device."""
        if self.world == 1:
            return t
        src = self._comm(_wire(t).contiguous())
        out = torch.empty_like(src)
        tdist.all_to_all_single(out, src)
        return _unwire(out, t.dtype).to(t.device)

    def barrier(self):
        if self.world > 1:
            tdist.barrier()


def _wire(t: torch.Tensor) -> torch.Tensor:
    """bool travels as uint8 (gloo has no bool collectives)."""
    return t.to(torch.uint8) if t.dtype == torch.bool else t


def _unwire(t: torch.Tensor, dtype) -> torch.Tensor:
    return t.to(torch.bool) if dtype == torch.bool else t


def as_mesh(layout) -> Mesh:
    """A `Mesh` as it is, or a shard count as the one-process layout of that
    many shards (what the step functions take)."""
    return layout if isinstance(layout, Mesh) else Mesh(int(layout))


def _rank_device(device) -> torch.device:
    """The device a rank's shards live on: "cuda" without an index means
    this process's card, `LOCAL_RANK` under torchrun (else the rank)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        rank = tdist.get_rank() if tdist.is_initialized() else 0
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                         rank)))
    return device


def make_mesh(nparts: int | None = None, device="cuda") -> Mesh:
    """The layout of `nparts` shards (default: one per rank) over the ranks
    of the initialized default group (one process without a group is world
    1).  The shards live on `device`: "cuda" resolves to
    this rank's card (`LOCAL_RANK`); name "cuda:i" to place ranks yourself
    (several ranks may share one card under gloo) or "cpu"."""
    if tdist.is_initialized():
        world, rank = tdist.get_world_size(), tdist.get_rank()
        backend = str(tdist.get_backend())
    else:
        world, rank, backend = 1, 0, None
    device = _rank_device(device)
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("an NCCL group needs the shards on a CUDA "
                             f"device, not {device}")
        torch.cuda.set_device(device)
    return Mesh(nparts if nparts is not None else world, device, world, rank,
                backend)


def make_mesh_2d(n_hosts: int | None = None, nparts: int | None = None,
                 device="cuda") -> Mesh:
    """The host-major (hosts x shards per host) layout — the reference's
    two-level hashing (kmer_hash.hpp:24-54: hash prefix -> process,
    suffix -> local bucket).  A rank is a host, so `n_hosts` must be the
    world size (default); shard g = host * (nparts // n_hosts) + local is
    owned exactly as in the 1-D layout of the same shard count."""
    mesh = make_mesh(nparts, device)
    n_hosts = mesh.world if n_hosts is None else n_hosts
    if n_hosts != mesh.world:
        raise ValueError(f"{n_hosts} hosts on a group of {mesh.world} ranks")
    return dataclasses.replace(mesh, shape=(n_hosts, mesh.p_local))
