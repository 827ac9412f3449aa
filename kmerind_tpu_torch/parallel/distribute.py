"""Owner-routed data exchange between p shards, on one rank or many.

The port of ``kmerind_tpu.parallel.distribute``.  `distribute` ships each
element to its owner shard and returns a `Route` addressing every input
element's position in the exchanged tensor; `undistribute` routes
per-element replies back to the original order (imxx::distribute /
undistribute, src/io/incremental_mxx.hpp:1040-1223).

Device model: each rank holds its p_local = p / W shards of an index
stacked as [p_local, ...] tensors on its device (one process: W = 1, all
p shards; ``parallel/mesh.py``).  Each source shard buckets its elements
by owner into a dense [p, C, ...] tensor (capacity C per destination; an
overflow count drives the caller's retry with a larger C).  On one rank
the JAX package's ``all_to_all`` over the mesh is a transpose of the
stacked [p_src, p_dst, C, ...] buckets; over W ranks the
[p_local, p, C, ...] buckets of every rank go through one
``torch.distributed.all_to_all_single`` (`Mesh.all_to_all`: staged
through host memory under gloo, device to device under NCCL) and come
back as [p_local, p * C, ...], source shards in global order.  C must be
the same on every rank, and the overflow a rank sees is all-reduced to
the global maximum, so every rank retries together.

With one shard every element is already owner-resident: the exchange is
the identity and costs nothing (any leading shape passes through).
"""

from __future__ import annotations

import dataclasses

import torch

from .mesh import as_mesh

__all__ = ["Route", "bucket_by_owner", "distribute", "undistribute"]


@dataclasses.dataclass
class Route:
    """Routing info for the source shards' elements ([p, n] each).  With one
    shard `owner` and `slot` are None (the identity route)."""

    owner: torch.Tensor | None   # int32 — destination shard of element i
    slot: torch.Tensor | None    # int64 — position in its destination bucket
    valid: torch.Tensor | None   # bool — element participated (None: all)
    overflow: int                # largest bucket excess over capacity


def bucket_by_owner(owner: torch.Tensor, valid: torch.Tensor, nparts: int,
                    capacity: int):
    """(bucket, slot) position of each element of ONE shard ([n] each).

    A stable argsort of the owners gives each element its rank within its
    owner's bucket: sorted position minus the bucket's start (bincount plus
    an exclusive cumsum) — the JAX package's cummax over run starts becomes
    a gather.  Returns (slot int64[n], counts int64[nparts] of valid
    elements, overflow 0-d).  Elements past `capacity` in their bucket get
    slot >= capacity (dropped; overflow reports how many)."""
    n = owner.shape[0]
    key = torch.where(valid, owner.to(torch.int64), nparts)
    order = torch.argsort(key, stable=True)
    sizes = torch.bincount(key, minlength=nparts + 1)
    starts = torch.cumsum(sizes, 0) - sizes
    slot = torch.empty(n, dtype=torch.int64, device=owner.device)
    slot[order] = torch.arange(n, device=owner.device) - starts[key[order]]
    counts = sizes[:nparts]
    return slot, counts, (counts.max() - capacity).clamp(min=0)


def distribute(arrays, owner: torch.Tensor | None, valid: torch.Tensor | None,
               nparts, capacity: int | None = None):
    """Ship each element to its owner shard — a collective over the ranks
    of a multi-rank `nparts`.

    arrays: tuple of [p_local, n] or [p_local, n, d] tensors routed
    together; owner int[p_local, n] destination shards (global); valid
    bool[p_local, n]; nparts: the shard count, or the `Mesh` of an index
    over several ranks; capacity: elements per (source, destination)
    bucket, the same on every rank.

    Returns (recv_arrays, recv_valid, route): each recv array is
    [p_local, p * capacity, ...] — destination shard d's concatenation of
    one capacity-sized bucket from every source shard — and recv_valid
    marks its live rows; route.overflow is the largest bucket excess over
    every rank.  With one shard the inputs come back as they are."""
    mesh = as_mesh(nparts)
    if mesh.nparts == 1:
        return tuple(arrays), valid, Route(None, None, valid, 0)
    p, c, pl = mesh.nparts, capacity, owner.shape[0]
    slot = torch.empty(owner.shape, dtype=torch.int64, device=owner.device)
    overflow = []
    for s in range(pl):
        slot[s], _, ovf = bucket_by_owner(owner[s], valid[s], p, c)
        overflow.append(ovf)
    live = valid & (slot < c)
    dest = torch.where(live, owner.to(torch.int64) * c + slot, p * c)
    src = torch.arange(pl, device=owner.device)[:, None]

    def exchange(x):
        tail = tuple(x.shape[2:])
        buf = x.new_zeros((pl, p * c + 1) + tail)
        buf[src, dest] = x
        send = buf[:, :-1].reshape((pl, p, c) + tail)      # [src, dst, C]
        return _swap(send, mesh).reshape((pl, p * c) + tail)

    route = Route(owner=owner, slot=slot, valid=live, overflow=mesh.all_max(
        int(torch.stack(overflow).max())))
    return tuple(exchange(x) for x in arrays), exchange(live), route


def _swap(send: torch.Tensor, mesh) -> torch.Tensor:
    """[p_local (src), p (dst), C, ...] buckets of every rank ->
    [p_local (dst), p (src), C, ...]: a transpose on one rank, one
    all-to-all over several (dst shard d = rank * p_local + local)."""
    if mesh.world == 1:
        return send.transpose(0, 1)
    pl, w = mesh.p_local, mesh.world
    tail = tuple(send.shape[2:])
    # [src_l, rank, dst_l, C] -> [rank, dst_l, src_l, C]: slab r to rank r
    out = mesh.all_to_all(send.reshape((pl, w, pl) + tail).permute(
        (1, 2, 0) + tuple(range(3, 3 + len(tail)))).contiguous())
    # [src rank, dst_l, src_l, C] -> [dst_l, src rank, src_l, C]
    return out.transpose(0, 1).reshape((pl, w * pl) + tail)


def undistribute(reply_arrays, route: Route, nparts,
                 capacity: int | None = None, fill=0):
    """Route per-element replies back to the original requesters — a
    collective over the ranks of a multi-rank `nparts`.

    `reply_arrays` are [p_local, p * capacity, ...] tensors aligned with
    the recv layout of `distribute`.  Returns [p_local, n, ...] tensors
    aligned with the original inputs; elements that did not take part
    (`route.valid` False) get `fill`."""

    def masked(x, valid):
        if valid is None:
            return x
        return torch.where(valid.reshape(valid.shape + (1,) * (
            x.dim() - valid.dim())), x, fill)

    mesh = as_mesh(nparts)
    if mesh.nparts == 1:
        return tuple(masked(x, route.valid) for x in reply_arrays)
    p, c, pl = mesh.nparts, capacity, route.owner.shape[0]
    idx = torch.where(route.valid, route.owner.to(torch.int64) * c
                      + route.slot, 0)
    src = torch.arange(pl, device=idx.device)[:, None]
    out = []
    for x in reply_arrays:
        tail = tuple(x.shape[2:])
        # the exchange is its own inverse: [dst, src, C] -> [src, dst, C]
        back = _swap(x.reshape((pl, p, c) + tail), mesh).reshape(
            (pl, p * c) + tail)                              # [src, dst*C]
        out.append(masked(back[src, idx], route.valid))
    return tuple(out)
