"""Plain PyTorch reference of kmerind's sort-based count map
(counting_sorted_map): every distinct k-mer of the reads once, in
ascending key order, with its count.

It works from generated read codes (uint8[r, L]: A, C, G, T = 0..3 and
N = 4, one read a row) and imports nothing of the packages under test.
Every k-window of a read is a k-mer, an N read as A (kmerind's 2-bit DNA
alphabet).  A k-mer is held as int64 limbs [nl], nl = ceil(k / 31): limb
j packs bases 31j .. 31j + 30 at 2 bits a base, the first base in the
top bits, so rows of limbs order lexicographically as the strings do.
Its canonical form is the lexicographically smaller of it and its
reverse complement.

`to_words` / `from_words` translate limbs to and from the key rows the
index API takes and returns: uint32 words of 16 bases each, the first
base in the top bits of word 0, the last word right-aligned.

Every function takes the device to compute on; `windows` works in
blocks of reads.
"""

from __future__ import annotations

import numpy as np
import torch

LIMB = 31
BLOCK_READS = 1 << 16


def nlimbs(k: int) -> int:
    return -(-k // LIMB)


def _limb_spans(k: int) -> list:
    return [(j * LIMB, min(k, (j + 1) * LIMB)) for j in range(nlimbs(k))]


def less(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bool[n]: row a < row b lexicographically, over limbs [n, nl] (b may
    be one row [nl])."""
    b = b.expand_as(a)
    out = torch.zeros(a.shape[0], dtype=torch.bool, device=a.device)
    for j in reversed(range(a.shape[1])):
        out = torch.where(a[:, j] != b[:, j], a[:, j] < b[:, j], out)
    return out


def windows(codes: np.ndarray, k: int, canonical: bool, device
            ) -> torch.Tensor:
    """int64 limbs [n, nl] of every k-window of the reads, read by read
    and window by window; canonical where asked."""
    out = []
    for lo in range(0, codes.shape[0], BLOCK_READS):
        c = torch.from_numpy(codes[lo:lo + BLOCK_READS]).to(device)
        x = torch.where(c == 4, 0, c).to(torch.int64)
        nwin = x.shape[1] - k + 1
        fwd, rc = [], []
        for a, b in _limb_spans(k):
            f = torch.zeros((x.shape[0], nwin), dtype=torch.int64,
                            device=device)
            r = torch.zeros_like(f)
            for i in range(a, b):
                f = (f << 2) | x[:, i:i + nwin]
                r = (r << 2) | (3 - x[:, k - 1 - i:k - 1 - i + nwin])
            fwd.append(f.reshape(-1))
            rc.append(r.reshape(-1))
        fwd, rc = torch.stack(fwd, 1), torch.stack(rc, 1)
        if canonical:
            fwd = torch.where(less(rc, fwd)[:, None], rc, fwd)
        out.append(fwd)
    if not out:
        return torch.zeros((0, nlimbs(k)), dtype=torch.int64, device=device)
    return torch.cat(out)


def table(codes: np.ndarray, k: int, device, canonical: bool = True):
    """(keys int64 [t, nl], counts int64 [t]): the distinct k-mers of the
    reads in ascending key order and their counts — what the map holds."""
    return torch.unique(windows(codes, k, canonical, device), dim=0,
                        sorted=True, return_counts=True)


def merge(*tables):
    """One table of several tables' keys, each key's counts summed."""
    keys = torch.cat([t[0] for t in tables])
    counts = torch.cat([t[1] for t in tables])
    uniq, inv = torch.unique(keys, dim=0, sorted=True, return_inverse=True)
    total = torch.zeros(uniq.shape[0], dtype=torch.int64, device=keys.device)
    return uniq, total.index_add_(0, inv, counts)


def lookup(keys: torch.Tensor, counts: torch.Tensor,
           queries: torch.Tensor) -> torch.Tensor:
    """int64[m]: each query row's count in the table, 0 where it is
    absent."""
    if keys.shape[0] == 0:
        return torch.zeros(queries.shape[0], dtype=torch.int64,
                           device=queries.device)
    _, inv = torch.unique(torch.cat([keys, queries]), dim=0,
                          return_inverse=True)
    kid, qid = inv[:keys.shape[0]], inv[keys.shape[0]:]
    pos = torch.searchsorted(kid, qid).clamp_(max=kid.numel() - 1)
    return torch.where(kid[pos] == qid, counts[pos], torch.zeros_like(qid))


def items_in_range(keys: torch.Tensor, counts: torch.Tensor,
                   lo: torch.Tensor, hi: torch.Tensor):
    """(keys, counts) of the entries with lo <= key < hi (limb rows
    [nl]), in key order."""
    keep = ~less(keys, lo) & less(keys, hi)
    return keys[keep], counts[keep]


def shard_sizes(keys: torch.Tensor, splitters: torch.Tensor,
                nparts: int) -> list:
    """Distinct keys each of `nparts` range shards holds under the p-1
    splitters (limb rows [p-1, nl]): shard i holds the keys k with
    splitter[i-1] <= k < splitter[i], a contiguous stretch of the table."""
    shard = torch.zeros(keys.shape[0], dtype=torch.int64, device=keys.device)
    for s in splitters:
        shard += (~less(keys, s)).to(torch.int64)
    return torch.bincount(shard, minlength=nparts).tolist()


def _bases(limbs: torch.Tensor, k: int) -> torch.Tensor:
    """int64 [n, k] base codes of limb rows."""
    cols = []
    for j, (a, b) in enumerate(_limb_spans(k)):
        for i in range(a, b):
            cols.append((limbs[:, j] >> (2 * (b - 1 - i))) & 3)
    return torch.stack(cols, 1)


def _pack(x: torch.Tensor, spans: list) -> torch.Tensor:
    """int64 [n, len(spans)]: base codes x [n, k] packed, span (a, b)
    holding bases a .. b - 1, the first on top."""
    out = []
    for a, b in spans:
        v = torch.zeros(x.shape[0], dtype=torch.int64, device=x.device)
        for i in range(a, b):
            v = (v << 2) | x[:, i]
        out.append(v)
    return torch.stack(out, 1)


def revcomp(limbs: torch.Tensor, k: int) -> torch.Tensor:
    """The limb rows of the reverse complements."""
    return _pack(3 - _bases(limbs, k).flip(1), _limb_spans(k))


def canonical(limbs: torch.Tensor, k: int) -> torch.Tensor:
    """Each limb row's canonical form: the smaller of it and its reverse
    complement."""
    rc = revcomp(limbs, k)
    return torch.where(less(rc, limbs)[:, None], rc, limbs)


def to_words(limbs: torch.Tensor, k: int) -> np.ndarray:
    """uint32 [n, ceil(k / 16)] API key rows of limb rows."""
    words = _pack(_bases(limbs, k),
                  [(a, min(k, a + 16)) for a in range(0, k, 16)])
    return words.to(torch.int32).cpu().numpy().view(np.uint32)


def from_words(words: np.ndarray, k: int, device) -> torch.Tensor:
    """Limb rows of uint32 [n, ceil(k / 16)] API key rows."""
    w = torch.from_numpy(np.asarray(words, np.uint32).astype(np.int64)
                         ).to(device)
    cols = []
    for j, a in enumerate(range(0, k, 16)):
        b = min(k, a + 16)
        for i in range(a, b):
            cols.append((w[:, j] >> (2 * (b - 1 - i))) & 3)
    return _pack(torch.stack(cols, 1), _limb_spans(k))


def to_int(limbs: torch.Tensor, k: int) -> int:
    """One limb row [nl] as the k-mer's integer (2 bits a base, the first
    base on top)."""
    out = 0
    for (a, b), v in zip(_limb_spans(k), limbs.tolist()):
        out = (out << (2 * (b - a))) | int(v)
    return out


def from_int(value: int, k: int) -> torch.Tensor:
    """The limb row [nl] of a k-mer's integer."""
    out = []
    for a, b in reversed(_limb_spans(k)):
        out.append(value & ((1 << (2 * (b - a))) - 1))
        value >>= 2 * (b - a)
    return torch.tensor(out[::-1], dtype=torch.int64)
