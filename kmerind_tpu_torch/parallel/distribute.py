"""Owner-routed data exchange — the single-shard slice.

The port of ``kmerind_tpu.parallel.distribute``.  `distribute` ships each
element to its owner shard and returns a `Route` addressing every input
element's position in the exchanged tensor; `undistribute` routes
per-element replies back to the original order (imxx::distribute /
undistribute, src/io/incremental_mxx.hpp:1040-1223).

Only ``nparts == 1`` exists yet: the whole batch is already
owner-resident, so the exchange is the identity and costs nothing.  The multi-shard bucket
exchange over ``torch.distributed`` is ROADMAP queue 1, item 5 (owner
exchange).
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["Route", "distribute", "undistribute"]

_MULTI_SHARD = ("the multi-shard exchange (nparts > 1) is not ported yet: "
                "ROADMAP queue 1, item 5 (owner exchange)")


@dataclasses.dataclass
class Route:
    """Routing info for one shard's input elements (shape [n] each)."""

    owner: torch.Tensor   # int32 — destination shard of element i
    slot: torch.Tensor    # int32 — position within its destination bucket
    valid: torch.Tensor   # bool — element participated


def distribute(arrays, owner: torch.Tensor | None, valid: torch.Tensor,
               nparts: int):
    """Ship each element to its owner shard.

    Returns (recv_arrays, recv_valid, route).  With one shard every element
    is already owner-resident: the inputs come back as they are and the
    route is None (nothing to route back)."""
    if nparts != 1:
        raise NotImplementedError(_MULTI_SHARD)
    return tuple(arrays), valid, None


def undistribute(reply_arrays, route: Route | None, nparts: int):
    """Route per-element replies back to the original requesters; with one
    shard the replies are already in request order."""
    if nparts != 1:
        raise NotImplementedError(_MULTI_SHARD)
    return tuple(reply_arrays)
