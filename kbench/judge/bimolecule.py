"""Judge of a Bimolecule count map (``BimoleculeCountIndex``).

`collect` takes what the measured calls produced: the answers of every
kept `find()` call, each (words in their stored orientation, counts) of
the queries found, in query order, and, where the mix builds in its
window, the last build's whole contents (`items()`).  `compare` holds
them against the plain reference (``kbench/reference/bimolecule.py``)
run on the same reads:

* answer_mismatches — answer rows whose canonical key or count differs
  from the reference's row at the same place (its found queries in
  query order), each missing or extra row counted as one;
* orientation_mismatches — rows whose key is the reference's but whose
  stored words are not (the other strand), in the answers and in the
  contents;
* distinct_gap — |distinct keys held - the reference's|;
* count_mismatches — reference keys whose held count differs, plus held
  keys the reference lacks.

Every number is exact: its limit is 0.  `control` is the reference put
in the program's place with each key stored in its LAST occurrence's
orientation, as a hash map that overwrites its key on every insert
would: the counts and found sets stay right and only the orientations
differ.
"""

from __future__ import annotations

import numpy as np
import torch

from kbench import data
from kbench.judge import count as count_judge
from kbench.reference import bimolecule as ref

LIMITS = {"answer_mismatches": 0, "orientation_mismatches": 0,
          "distinct_gap": 0, "count_mismatches": 0}


def _codes(words: np.ndarray, k: int) -> np.ndarray:
    return data.words_to_codes(np.asarray(words, np.uint32), k)


def collect(idx, run) -> dict:
    k = run.cfg["k"]
    out = {"answers": [(name, (_codes(w, k), np.asarray(c, np.int64)))
                       for name, (w, c) in run.window.answers]}
    if run.check_contents:
        words, counts = idx.items()
        out["keys"] = _codes(words, k)
        out["counts"] = counts.astype(np.int64)
    return out


def query_codes(inputs, sets, device) -> dict:
    """{query set: int64 canonical codes of its held-out windows}: find
    answers a query of either strand by its canonical key."""
    return {name: ref.windows(inputs.held[lo:hi], inputs.k, device)[0]
            for name, (lo, hi) in sets.items()}


def _rows(got_codes, got_counts, want_codes, want_counts, k):
    """(answer_mismatches, orientation_mismatches) of rows laid side by
    side: a row whose canonical key or count differs is an answer
    mismatch; one whose key and count agree but whose stored words do
    not, an orientation mismatch; each missing or extra row an answer
    mismatch."""
    n = min(got_codes.numel(), want_codes.numel())
    g, w = got_codes[:n], want_codes[:n]
    same_key = (ref.canonical(g, k) == ref.canonical(w, k)) & (
        got_counts[:n] == want_counts[:n])
    return (int((~same_key).sum()) + abs(got_codes.numel()
                                         - want_codes.numel()),
            int((same_key & (g != w)).sum()))


def compare(outputs, inputs, sets, seed, device) -> list:
    k = inputs.k
    keys, counts, strand = ref.table(inputs.codes, k, device)
    queries = query_codes(inputs, sets, device)
    put = lambda a: torch.from_numpy(np.asarray(a)).to(device)  # noqa: E731
    answers = orient = 0
    want_of = {}
    for name, (got_w, got_c) in outputs["answers"]:
        if name not in want_of:
            want_of[name] = ref.find(keys, counts, strand, queries[name], k)
        a, o = _rows(put(got_w), put(got_c), *want_of[name], k)
        answers, orient = answers + a, orient + o
    checks = [("answer_mismatches", answers)]
    if "keys" in outputs:
        got = put(outputs["keys"])
        canon = ref.canonical(got, k)
        order = torch.argsort(canon)
        got, canon = got[order], canon[order]
        got_c = put(outputs["counts"])[order]
        if keys.numel():
            pos = torch.searchsorted(keys, canon).clamp_(
                max=keys.numel() - 1)
            orient += int(((keys[pos] == canon) & (
                got != ref.stored(keys, strand, k)[pos])).sum())
        checks += count_judge.content_checks(keys, counts, canon, got_c)
    checks.insert(1, ("orientation_mismatches", orient))
    return [(n, v, LIMITS[n]) for n, v in checks]


def control(inputs, sets, contents: bool, device, seed: int) -> dict:
    """The outputs of a map that stores each key in its last occurrence's
    orientation: one answer per query set and, with `contents`, every
    key."""
    k = inputs.k
    keys, counts, last = ref.table(inputs.codes, k, device, last=True)
    out = {"answers": [
        (name, tuple(t.cpu().numpy()
                     for t in ref.find(keys, counts, last, q, k)))
        for name, q in query_codes(inputs, sets, device).items()]}
    if contents:
        w, c = ref.items(keys, counts, last, k)
        out["keys"], out["counts"] = w.cpu().numpy(), c.cpu().numpy()
    return out

