"""Judge of a canonical position + quality index (``PositionQualityIndex``).

`collect` takes the answers of every kept `count()` call and, where the
mix builds in its window, the index's pair and key totals (`size()`,
`unique_size()`) and, for a sample of k-mers drawn from the seed (the
canonical k-mers of 16,384 windows of the reads, and 256 random
k-mers), `count()` and `find(with_quality=True)`.  `compare` holds them
against the plain reference (``kbench/reference/kmers.py``):

* answer_mismatches — as in ``count.py``;
* pair_gap — |pairs held - windows of the reads|;
* distinct_gap — |distinct k-mers held - the reference's|;
* sample_count_mismatches — sampled k-mers whose count differs;
* find_pair_mismatches — (sampled k-mer, position id) pairs found but
  not in the reference, or in it but not found;
* quality_zero_mismatches — found pairs whose quality is 0 where the
  reference's is not, or the other way;
* quality_rel_err — the largest |found - reference| / reference quality
  over the found pairs whose reference quality is above 0.

All but quality_rel_err are exact (limit 0).  The configuration stores
window qualities in float32; `control` is the reference put in the
program's place with its qualities rounded to bfloat16, the next
precision below.
"""

from __future__ import annotations

import numpy as np
import torch

from kbench import data
from kbench.judge import count as count_judge
from kbench.reference import kmers as ref

#: quality_rel_err's limit lies between the readings of sound runs and
#: of the bfloat16 control (both in PERF.md, section 2)
LIMITS = {"answer_mismatches": 0, "pair_gap": 0, "distinct_gap": 0,
          "sample_count_mismatches": 0, "find_pair_mismatches": 0,
          "quality_zero_mismatches": 0, "quality_rel_err": 1e-4}
SAMPLE_WINDOWS = 1 << 14
SAMPLE_RANDOM = 256


def sample_keys(inputs, seed: int) -> np.ndarray:
    """Sorted distinct int64 canonical codes: those of SAMPLE_WINDOWS
    windows of the reads drawn from the seed (N read as A) and
    SAMPLE_RANDOM random k-mers."""
    k = inputs.k
    rng = np.random.default_rng(int(seed) % (1 << 63) + 11)
    nwin = inputs.codes.shape[1] - k + 1
    r = rng.integers(0, inputs.codes.shape[0], SAMPLE_WINDOWS)
    j = rng.integers(0, nwin, SAMPLE_WINDOWS)
    win = inputs.codes[r[:, None], j[:, None] + np.arange(k)].astype(np.int64)
    win[win == 4] = 0
    fwd = np.zeros(win.shape[0], np.int64)
    rc = np.zeros(win.shape[0], np.int64)
    for i in range(k):
        fwd = (fwd << 2) | win[:, i]
        rc = (rc << 2) | (3 - win[:, k - 1 - i])
    rand = rng.integers(0, 1 << (2 * k), SAMPLE_RANDOM, dtype=np.int64)
    rand_rc = np.zeros_like(rand)
    for i in range(k):
        rand_rc = (rand_rc << 2) | (3 - ((rand >> (2 * i)) & 3))
    return np.unique(np.concatenate([np.minimum(fwd, rc),
                                     np.minimum(rand, rand_rc)]))


def collect(idx, run) -> dict:
    out = {"answers": list(run.window.answers)}
    if run.check_contents:
        k = run.cfg["k"]
        out["size"] = idx.size()
        out["unique_size"] = idx.unique_size()
        keys = sample_keys(run.inputs, run.seed)
        rows = data.codes_to_words(keys, k)
        out["sample_keys"] = keys
        out["sample_counts"] = np.asarray(idx.count(rows), np.int64)
        ids, quals, mask = idx.find(rows, with_quality=True)
        r, c = np.nonzero(mask)
        out["find_key"] = r.astype(np.int64)
        out["find_id"] = ids[r, c].astype(np.int64)
        out["find_q"] = quals[r, c].astype(np.float64)
    return out


def find_checks(key_idx, ids, qs, want_key_idx, want_ids, want_qs) -> list:
    """find_pair_mismatches, quality_zero_mismatches, quality_rel_err of
    found (sample index, id, quality) triples against the reference's."""
    shift = 1 << 46                      # ids < 2^46: record start << 16
    got = key_idx * shift + ids
    want = want_key_idx * shift + want_ids
    want, order = torch.sort(want)
    want_qs = want_qs[order]
    if want.numel() and got.numel():
        pos = torch.searchsorted(want, got).clamp_(max=want.numel() - 1)
        hit = want[pos] == got
    else:
        pos = torch.zeros_like(got)
        hit = torch.zeros_like(got, dtype=torch.bool)
    found = torch.zeros(want.numel(), dtype=torch.int64, device=want.device)
    found.index_add_(0, pos[hit], torch.ones_like(pos[hit]))
    pair_bad = (int((~hit).sum()) + int((found == 0).sum())
                + int((found > 1).sum()))
    gq, wq = qs[hit], want_qs[pos[hit]]
    zero_bad = int(((gq == 0) != (wq == 0)).sum())
    live = wq > 0
    rel = float(((gq[live] - wq[live]).abs() / wq[live]).max()) \
        if bool(live.any()) else 0.0
    return [("find_pair_mismatches", pair_bad),
            ("quality_zero_mismatches", zero_bad), ("quality_rel_err", rel)]


def compare(outputs, inputs, sets, seed, device) -> list:
    keys, counts = ref.window_table(inputs.codes, inputs.k, device)
    queries = count_judge.query_codes(inputs, sets, device)
    checks = [("answer_mismatches", count_judge.answer_mismatches(
        outputs["answers"], queries,
        lambda q: ref.lookup(keys, counts, q)))]
    if "size" in outputs:
        sample = torch.from_numpy(outputs["sample_keys"]).to(device)
        want_counts = ref.lookup(keys, counts, sample)
        got_counts = torch.from_numpy(outputs["sample_counts"]).to(device)
        checks += [
            ("pair_gap", abs(outputs["size"] - int(counts.sum()))),
            ("distinct_gap", abs(outputs["unique_size"] - keys.numel())),
            ("sample_count_mismatches",
             int((got_counts != want_counts).sum()))]
        del keys, counts
        wk, wid, wq = ref.window_pairs(
            inputs.codes, inputs.quals, inputs.k, sample,
            inputs.record_bytes, inputs.seq_offset, device)
        put = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
        checks += find_checks(
            put(outputs["find_key"]), put(outputs["find_id"]),
            put(outputs["find_q"]), torch.searchsorted(sample, wk), wid, wq)
    return [(n, v, LIMITS[n]) for n, v in checks]


def control(inputs, sets, contents: bool, device, seed: int) -> dict:
    """The reference's outputs with every quality rounded to bfloat16."""
    keys, counts = ref.window_table(inputs.codes, inputs.k, device)
    out = {"answers": [
        (name, ref.lookup(keys, counts, q).cpu().numpy())
        for name, q in count_judge.query_codes(inputs, sets,
                                               device).items()]}
    if contents:
        sample_np = sample_keys(inputs, seed)
        sample = torch.from_numpy(sample_np).to(device)
        out.update(size=int(counts.sum()), unique_size=keys.numel(),
                   sample_keys=sample_np,
                   sample_counts=ref.lookup(keys, counts, sample)
                   .cpu().numpy())
        wk, wid, wq = ref.window_pairs(
            inputs.codes, inputs.quals, inputs.k, sample,
            inputs.record_bytes, inputs.seq_offset, device)
        out.update(find_key=torch.searchsorted(sample, wk).cpu().numpy(),
                   find_id=wid.cpu().numpy(),
                   find_q=wq.to(torch.bfloat16).to(torch.float64)
                   .cpu().numpy())
    return out
