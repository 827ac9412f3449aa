"""Sample sort over p shards, on one rank or many.

The port of ``kmerind_tpu.parallel.sample_sort`` — the reference's
``mxx::sort`` sample sort as the sorted distributed maps use it
(distributed_sorted_map.hpp:2061, imxx::samplesort_buf,
src/io/incremental_mxx.hpp:2431): each shard sorts locally and contributes
evenly spaced samples, the gathered samples define p-1 splitters, elements
route to the shard owning their splitter range (`distribute`), and each
shard sorts what it received.  The result is globally sorted: shard i's
keys all precede shard i+1's.

Each rank's shards are stacked [p_local, ...] tensors
(``parallel/distribute.py``): the JAX package's ``all_gather`` of the
samples is a concatenation of the local shards' samples and, over several
ranks, an all-gather of those, so every rank derives the same splitters.
"""

from __future__ import annotations

import torch

from ..ops import sortops
from ..ops.keys import SENTINEL
from ..ops.packing import lex_less
from . import distribute as dist
from .mesh import as_mesh

__all__ = ["global_splitters", "owners_from_splitters", "sample_sort"]


def global_splitters(words: torch.Tensor, valid: torch.Tensor, nparts,
                     oversample: int, sentinel_ok: bool = False):
    """int32[p-1, w] splitters of shards words[p_local, n, w] /
    valid[p_local, n] — a collective over the ranks of a multi-rank
    `nparts` (a shard count or a `Mesh`).

    Each shard sorts its rows and samples `oversample` evenly spaced valid
    rows — the all-ones sentinel where it has fewer, so empty shards do not
    bias the splitters — the samples of all shards of all ranks are
    sorted, and p-1 evenly spaced of them are the splitters.  One shard
    has none."""
    mesh = as_mesh(nparts)
    nparts = mesh.nparts
    if nparts == 1:
        return words.new_zeros((0, words.shape[-1]))
    samples = []
    for s in range(words.shape[0]):
        s_words, _, s_valid = sortops.sort_rows(
            words[s], (), valid[s], is_stable=False, sentinel_ok=sentinel_ok)
        tv = s_valid.sum()
        j = torch.arange(1, oversample + 1, device=words.device)
        pos = (j * tv // (oversample + 1)).clamp(0, s_words.shape[0] - 1)
        samples.append(torch.where((pos < tv)[:, None], s_words[pos],
                                   SENTINEL))
    g_sorted, _, _ = sortops.sort_rows(mesh.all_gather(torch.cat(samples)),
                                       ())
    m = g_sorted.shape[0]
    spos = (torch.arange(1, nparts, device=words.device) * m
            // nparts).clamp(0, m - 1)
    return g_sorted[spos]


def owners_from_splitters(words: torch.Tensor, splitters: torch.Tensor,
                          nparts) -> torch.Tensor | None:
    """Destination shard per key row [..., w]: the number of splitters <=
    the key (the reference's splitter binary search,
    distributed_sorted_map.hpp:1568-1600).  None with one shard, where every
    row is owned by shard 0."""
    if as_mesh(nparts).nparts == 1:
        return None
    return (~lex_less(words[..., None, :], splitters)).sum(dim=-1)


def sample_sort(words: torch.Tensor, valid: torch.Tensor, capacity: int,
                oversample: int = 8):
    """Globally sort the valid rows of words[p, n, w] (valid[p, n]).

    Returns (sorted_words [p, n2, w], out_valid [p, n2], overflow) with
    n2 = p * capacity (n with one shard): each shard's valid rows sorted
    first, and every key of shard i before every key of shard i+1.
    capacity is the bucket size per (source, destination) pair; overflow > 0
    means a bucket was too small and rows were dropped (retry larger)."""
    p = words.shape[0]
    splitters = global_splitters(words, valid, p, oversample)
    owner = owners_from_splitters(words, splitters, p)
    (rw,), rvalid, route = dist.distribute((words,), owner, valid, p,
                                           capacity)
    out = [sortops.sort_rows(rw[s], (), rvalid[s]) for s in range(p)]
    return (torch.stack([o[0] for o in out]), torch.stack([o[2] for o in out]),
            route.overflow)
