"""Judge of a canonical count index (``CountIndex``).

`collect` takes what the measured calls produced: the answers of every
kept `count()` call and, where the mix builds in its window, the index's
whole contents (`items()`).  `compare` holds them against the plain
reference (``kbench/reference/kmers.py``) run on the same reads:

* answer_mismatches — query answers that differ from the reference's
  count of the query's canonical k-mer (0 where absent);
* distinct_gap — |distinct k-mers held - the reference's|;
* count_mismatches — reference k-mers whose held count differs, plus
  held k-mers the reference lacks.

Every number is exact: its limit is 0.  `control` is the reference put
in the program's place with each k-mer keyed by the low 32 of its 62 key
bits, the narrower key that would tempt a later change: colliding
k-mers then share a count.
"""

from __future__ import annotations

import numpy as np
import torch

from kbench import data
from kbench.reference import kmers as ref

LIMITS = {"answer_mismatches": 0, "distinct_gap": 0, "count_mismatches": 0}
LOW32 = (1 << 32) - 1


def collect(idx, run) -> dict:
    out = {"answers": list(run.window.answers)}
    if run.check_contents:
        words, counts = idx.items()
        out["keys"] = data.words_to_codes(words, run.cfg["k"])
        out["counts"] = counts.astype(np.int64)
    return out


def query_codes(inputs, sets, device) -> dict:
    """{query set: reference canonical codes of its held-out windows}."""
    return {name: ref.canonical_codes(inputs.held[lo:hi], inputs.k, device)
            for name, (lo, hi) in sets.items()}


def answer_mismatches(answers, queries: dict, lookup) -> int:
    """Answers that differ from `lookup(codes)` of their set's queries,
    each missing or extra answer counted as one."""
    bad, want_of = 0, {}
    for name, ans in answers:
        if name not in want_of:
            want_of[name] = lookup(queries[name])
        want = want_of[name]
        got = torch.from_numpy(np.asarray(ans, np.int64)).to(want.device)
        n = min(got.numel(), want.numel())
        bad += int((got[:n] != want[:n]).sum()) + abs(
            got.numel() - want.numel())
    return bad


def content_checks(keys, counts, got_keys, got_counts) -> list:
    """distinct_gap and count_mismatches of held (got_keys, got_counts)
    against the reference table (keys, counts), all int64 tensors."""
    gk, order = torch.sort(got_keys)
    gc = got_counts[order]
    dups = int((gk[1:] == gk[:-1]).sum()) if gk.numel() > 1 else 0
    held = ref.lookup(gk, gc, keys)
    extra = int((ref.lookup(keys, torch.ones_like(keys), gk) == 0).sum())
    return [("distinct_gap", abs(gk.numel() - keys.numel())),
            ("count_mismatches", int((held != counts).sum()) + extra + dups)]


def compare(outputs, inputs, sets, seed, device) -> list:
    keys, counts = ref.window_table(inputs.codes, inputs.k, device)
    queries = query_codes(inputs, sets, device)
    checks = [("answer_mismatches", answer_mismatches(
        outputs["answers"], queries,
        lambda q: ref.lookup(keys, counts, q)))]
    if "keys" in outputs:
        checks += content_checks(
            keys, counts, torch.from_numpy(outputs["keys"]).to(device),
            torch.from_numpy(outputs["counts"]).to(device))
    return [(n, v, LIMITS[n]) for n, v in checks]


def control(inputs, sets, contents: bool, device, seed: int) -> dict:
    """The outputs of a count index that keys each k-mer by its low 32
    bits: one answer per query set, and with `contents` every distinct
    k-mer with the count of its 32-bit key."""
    canon = ref.canonical_codes(inputs.codes, inputs.k, device)
    k32, c32 = torch.unique(canon & LOW32, sorted=True, return_counts=True)
    del canon
    out = {"answers": [
        (name, ref.lookup(k32, c32, q & LOW32).cpu().numpy())
        for name, q in query_codes(inputs, sets, device).items()]}
    if contents:
        keys, _ = ref.window_table(inputs.codes, inputs.k, device)
        out["keys"] = keys.cpu().numpy()
        out["counts"] = ref.lookup(k32, c32, keys & LOW32).cpu().numpy()
    return out
