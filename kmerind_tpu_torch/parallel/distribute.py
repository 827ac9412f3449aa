"""Owner-routed data exchange between p shards held by one process.

The port of ``kmerind_tpu.parallel.distribute``.  `distribute` ships each
element to its owner shard and returns a `Route` addressing every input
element's position in the exchanged tensor; `undistribute` routes
per-element replies back to the original order (imxx::distribute /
undistribute, src/io/incremental_mxx.hpp:1040-1223).

Device model: one process holds all p shards of an index stacked as
[p, ...] tensors on one device.  Each source shard buckets its elements by
owner into a dense [p, C, ...] tensor (capacity C per destination; an
overflow count drives the caller's retry with a larger C), and the JAX
package's ``all_to_all`` over the mesh becomes a transpose of the stacked
[p_src, p_dst, C, ...] buckets.  Multi-process exchange over
``torch.distributed`` is ROADMAP queue 1, item 16.

With one shard every element is already owner-resident: the exchange is
the identity and costs nothing (any leading shape passes through).
"""

from __future__ import annotations

import dataclasses

import torch

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
               nparts: int, capacity: int | None = None):
    """Ship each element to its owner shard.

    arrays: tuple of [p, n] or [p, n, d] tensors routed together; owner
    int[p, n] destination shards; valid bool[p, n]; capacity: elements per
    (source, destination) bucket.

    Returns (recv_arrays, recv_valid, route): each recv array is
    [p, p * capacity, ...] — destination shard d's concatenation of one
    capacity-sized bucket from every source shard — and recv_valid marks
    its live rows.  With one shard the inputs come back as they are."""
    if nparts == 1:
        return tuple(arrays), valid, Route(None, None, valid, 0)
    p, c = nparts, capacity
    slot = torch.empty(owner.shape, dtype=torch.int64, device=owner.device)
    overflow = []
    for s in range(p):
        slot[s], _, ovf = bucket_by_owner(owner[s], valid[s], p, c)
        overflow.append(ovf)
    live = valid & (slot < c)
    dest = torch.where(live, owner.to(torch.int64) * c + slot, p * c)
    src = torch.arange(p, device=owner.device)[:, None]

    def exchange(x):
        tail = tuple(x.shape[2:])
        buf = x.new_zeros((p, p * c + 1) + tail)
        buf[src, dest] = x
        send = buf[:, :-1].reshape((p, p, c) + tail)       # [src, dst, C]
        return send.transpose(0, 1).reshape((p, p * c) + tail)

    route = Route(owner=owner, slot=slot, valid=live,
                  overflow=int(torch.stack(overflow).max()))
    return tuple(exchange(x) for x in arrays), exchange(live), route


def undistribute(reply_arrays, route: Route, nparts: int,
                 capacity: int | None = None, fill=0):
    """Route per-element replies back to the original requesters.

    `reply_arrays` are [p, p * capacity, ...] tensors aligned with the
    recv layout of `distribute`.  Returns [p, n, ...] tensors aligned with
    the original inputs; elements that did not take part (`route.valid`
    False) get `fill`."""

    def masked(x, valid):
        if valid is None:
            return x
        return torch.where(valid.reshape(valid.shape + (1,) * (
            x.dim() - valid.dim())), x, fill)

    if nparts == 1:
        return tuple(masked(x, route.valid) for x in reply_arrays)
    p, c = nparts, capacity
    idx = torch.where(route.valid, route.owner.to(torch.int64) * c
                      + route.slot, 0)
    src = torch.arange(p, device=idx.device)[:, None]
    out = []
    for x in reply_arrays:
        tail = tuple(x.shape[2:])
        back = x.reshape((p, p, c) + tail).transpose(0, 1).reshape(
            (p, p * c) + tail)                               # [src, dst*C]
        out.append(masked(back[src, idx], route.valid))
    return tuple(out)
