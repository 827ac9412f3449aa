"""Judge of `find(with_quality=True)` batches on a canonical position +
quality index (``PositionQualityIndex``).

`collect` takes the kept answers: (ids uint64[m, width], qualities
float32[m, width], mask bool[m, width]) of a pooled query set each.
`compare` holds every found (query row, position id, quality) against
the plain reference (``kbench/reference/kmers.py``): each query row is
owed every (id, quality) pair of its canonical k-mer
(`window_pairs`).  The numbers are ``position_quality.find_checks``'
with its limits, summed over the answers (quality_rel_err: the largest):

* find_pair_mismatches — (row, id) pairs found but not owed, or owed but
  not found, or found twice;
* quality_zero_mismatches — found pairs whose quality is 0 where the
  reference's is not, or the other way;
* quality_rel_err — the largest |found - reference| / reference quality
  over the found pairs whose reference quality is above 0.

A batch has 581,632 rows and ids reach 2^45, so (row, id) does not fit
one int64: both sides' pairs are ranked together (`torch.unique` over
rows of two columns) and the ranks matched.  `control` is the reference
put in the program's place for the first query set, its qualities
rounded to bfloat16, the next precision below the configuration's
float32.
"""

from __future__ import annotations

import numpy as np
import torch

from kbench.judge import count as count_judge
from kbench.judge import position_quality as pq
from kbench.reference import kmers as ref

LIMITS = {n: pq.LIMITS[n] for n in ("find_pair_mismatches",
                                    "quality_zero_mismatches",
                                    "quality_rel_err")}


def collect(idx, run) -> dict:
    return {"answers": list(run.window.answers)}


def owed(inputs, names, sets, device) -> dict:
    """{query set: (its rows, (row, id, quality) of every reference pair
    of each query row's canonical k-mer)} of the sets `names`; a row
    missing from or added to an answer shows as pairs not found or not
    owed."""
    queries = count_judge.query_codes(inputs, {n: sets[n] for n in names},
                                      device)
    keep = torch.unique(torch.cat(list(queries.values())))
    wk, wid, wq = ref.window_pairs(inputs.codes, inputs.quals, inputs.k,
                                   keep, inputs.record_bytes,
                                   inputs.seq_offset, device)
    wk, order = torch.sort(wk)
    wid, wq = wid[order], wq[order]
    out = {}
    for name, q in queries.items():
        lo = torch.searchsorted(wk, q)
        n = torch.searchsorted(wk, q, right=True) - lo
        first = torch.cumsum(n, 0) - n
        row = torch.repeat_interleave(torch.arange(q.numel(), device=device),
                                      n)
        at = torch.repeat_interleave(lo - first, n) + torch.arange(
            row.numel(), device=device)
        out[name] = (q.numel(), (row, wid[at], wq[at]))
    return out


def pair_checks(got, want) -> list:
    """find_checks of found (row, id, quality) against owed ones, the
    (row, id) pairs replaced by their joint ranks."""
    rows = torch.cat([torch.stack(got[:2], 1), torch.stack(want[:2], 1)])
    _, rank = torch.unique(rows, dim=0, return_inverse=True)
    n = got[0].numel()
    zero = lambda t: torch.zeros_like(t)  # noqa: E731
    return pq.find_checks(zero(rank[:n]), rank[:n], got[2],
                          zero(rank[n:]), rank[n:], want[2])


def compare(outputs, inputs, sets, seed, device) -> list:
    answers = outputs["answers"]
    want = owed(inputs, sorted({n for n, _ in answers}), sets, device)
    totals = {n: 0 for n in LIMITS}
    for name, (ids, quals, mask) in answers:
        r, c = np.nonzero(mask)
        got = tuple(torch.from_numpy(a).to(device) for a in (
            r.astype(np.int64), ids[r, c].astype(np.int64),
            quals[r, c].astype(np.float64)))
        for n, v in pair_checks(got, want[name][1]):
            totals[n] = max(totals[n], v) if n == "quality_rel_err" \
                else totals[n] + v
    return [(n, v, LIMITS[n]) for n, v in totals.items()]


def control(inputs, sets, contents: bool, device, seed: int) -> dict:
    """The reference's answer to the first query set, each quality rounded
    to bfloat16."""
    name = next(iter(sets))
    m, (row, wid, wq) = owed(inputs, [name], sets, device)[name]
    n = torch.bincount(row, minlength=m)
    width = max(int(n.max()) if m else 1, 1)
    col = torch.arange(row.numel(), device=device) - torch.repeat_interleave(
        torch.cumsum(n, 0) - n, n)
    ids = torch.zeros((m, width), dtype=torch.int64, device=device)
    qs = torch.zeros((m, width), dtype=torch.float32, device=device)
    mask = torch.zeros((m, width), dtype=torch.bool, device=device)
    ids[row, col] = wid
    qs[row, col] = wq.to(torch.bfloat16).to(torch.float32)
    mask[row, col] = True
    return {"answers": [(name, (ids.cpu().numpy().astype(np.uint64),
                                qs.cpu().numpy(), mask.cpu().numpy()))]}
