"""The port's tracing: `PhaseTimer` phases as profiler ranges named
"kmerind/<phase>" only while a profiler runs, and the spans where a build
and a count batch wait (feed_wait, marshal.ids, h2d, flush, rows, aux,
count.lookup, count.reply), on the CPU."""

import json
import pathlib
import tempfile

import numpy as np
import pytest
import torch

import kmerind_tpu_torch as kt
from kmerind_tpu_torch.utils.timers import RANGE_PREFIX, PhaseTimer

from torch_parity import write_reads

#: the ranges a benchmark harness opens around its calls into the port
HARNESS_RANGES = ("build", "first_query", "count_batch")
SPEC = kt.KmerSpec(21, kt.DNA)
#: every index family that builds from a file, as a factory
FAMILIES = {
    "count": lambda: kt.CountIndex(SPEC, device="cpu", max_runs=2),
    "sorted_count": lambda: kt.SortedCountIndex(SPEC, device="cpu"),
    "position_quality": lambda: kt.PositionQualityIndex(SPEC, device="cpu",
                                                        canonical=True),
    "sorted_position": lambda: kt.SortedPositionIndex(SPEC, device="cpu"),
    "value": lambda: kt.KmerValueIndex(SPEC, device="cpu", reduce="min"),
    "sorted_value": lambda: kt.SortedKmerValueIndex(SPEC, device="cpu",
                                                    reduce="max"),
    "bimolecule": lambda: kt.BimoleculeCountIndex(SPEC, device="cpu"),
    "debruijn": lambda: kt.DeBruijnGraph(SPEC, device="cpu", max_runs=2),
}


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    path = tmp_path_factory.mktemp("tracing") / "reads.fastq"
    strings = write_reads(path, 120, 90, 3000, seed=5, fmt="fastq",
                          varied_quality=True)
    return path, [s[:21] for s in strings[:40]]


def chunked(idx, chunk_bases=2048):
    """`idx` streaming its builds in chunks of `chunk_bases` bases."""
    idx.default_chunk_bases = chunk_bases
    return idx


def profiled(fn):
    """(fn's result, the chrome trace's user annotations as (name, start,
    end)) of fn run under torch.profiler on the CPU."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    return out, [(ev["name"], float(ev["ts"]), float(ev["ts"] + ev["dur"]))
                 for ev in events if ev.get("cat") == "user_annotation"]


class _Counting:
    """A stand-in for `record_function` that counts the ranges opened."""

    def __init__(self, real):
        self.real, self.opened = real, 0

    def __call__(self, *a, **kw):
        self.opened += 1
        return self.real(*a, **kw)


def test_no_range_is_opened_without_a_profiler(reads, monkeypatch):
    """With no profiler active, no path opens a `record_function`: a
    chunked position+quality build, its counts and finds, and a count
    index's build and counts."""
    path, queries = reads
    counting = _Counting(torch.profiler.record_function)
    monkeypatch.setattr(torch.profiler, "record_function", counting)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", counting)
    pq = chunked(FAMILIES["position_quality"]())
    pq.flush_rows = 4096
    pq.build(str(path))
    pq.count(queries)
    pq.find(queries, with_quality=True)
    ci = chunked(FAMILIES["count"]())
    ci.build(str(path))
    ci.count(queries)
    assert counting.opened == 0
    for t in (pq.timer, ci.timer):
        assert {"feed_wait", "h2d", "rows", "aux", "count.lookup",
                "count.reply"} <= set(t.durations)


def test_phases_are_profiler_ranges_under_a_profiler():
    t = PhaseTimer()

    def work():
        with t.phase("count"):
            with t.phase("count.lookup"):
                torch.ones(4).add_(1)
        with t.phase("h2d"):
            pass

    _, ranges = profiled(work)
    names = [n for n, _, _ in ranges]
    assert sorted(names) == sorted(RANGE_PREFIX + n for n in
                                   ("count", "count.lookup", "h2d"))
    (_, plo, phi), = [r for r in ranges if r[0] == "kmerind/count"]
    (_, clo, chi), = [r for r in ranges if r[0] == "kmerind/count.lookup"]
    assert plo <= clo <= chi <= phi
    assert t.count("count") == t.count("count.lookup") == t.count("h2d") == 1


def test_a_disabled_timer_opens_no_range():
    t = PhaseTimer(enabled=False)

    def work():
        with t.phase("count"):
            pass

    _, ranges = profiled(work)
    assert ranges == [] and t.durations == {}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_program_ranges_are_prefixed_and_h2d_is_its_own(family, reads):
    """Under the profiler, a chunked build and a query of every index
    family open only "kmerind/" ranges (none under a harness's names),
    an "h2d" range per chunk on the main thread, and no "h2d" inside an
    "insert"."""
    path, queries = reads
    idx = chunked(FAMILIES[family]())
    query = idx.node_counts if family == "debruijn" else idx.count

    def work():
        idx.build(str(path))
        query(queries)

    _, ranges = profiled(work)
    names = {n for n, _, _ in ranges}
    assert names and all(n.startswith(RANGE_PREFIX) for n in names)
    assert not names & set(HARNESS_RANGES)
    h2d = [(lo, hi) for n, lo, hi in ranges if n == "kmerind/h2d"]
    inserts = [(lo, hi) for n, lo, hi in ranges if n == "kmerind/insert"]
    assert len(h2d) == idx.timer.count("h2d") == \
        idx.timer.count("feed_wait") - 1 > 1
    assert not any(ilo <= lo and hi <= ihi
                   for lo, hi in h2d for ilo, ihi in inserts)
    assert idx.timer.count("rows") == 1


def test_pq_build_records_where_it_waits(reads):
    """A position+quality build of several chunks, with flushes while it
    builds, then its first count."""
    path, queries = reads
    idx = chunked(FAMILIES["position_quality"]())
    idx.flush_rows = 8000
    idx.build(str(path))
    assert idx._pending, "the last chunks wait for the first count's flush"
    t = idx.timer
    chunks = t.count("insert")
    assert chunks > 2
    # one wait per chunk, and the last one finds the feed exhausted
    assert t.count("feed_wait") == chunks + 1
    assert t.count("h2d") == chunks
    assert t.count("marshal.ids") == t.count("marshal") == chunks
    assert t.total("marshal.ids") <= t.total("marshal")
    assert t.count("flush") >= 1
    assert t.count("merge") == t.count("flush")
    assert t.total("merge") <= t.total("flush")
    flushes = t.count("flush")
    idx.count(queries)
    assert t.count("flush") == flushes + 1
    assert t.count("aux") == 1
    idx.count(queries)
    assert t.count("aux") == 1, "a cached aux is no span"


@pytest.mark.parametrize("family", ["count", "position_quality"])
def test_count_records_rows_lookup_and_reply_once_a_call(family, reads):
    path, queries = reads
    idx = FAMILIES[family]()
    idx.build(str(path))
    want = idx.count(queries)
    idx.timer.clear()
    got = idx.count(queries)
    np.testing.assert_array_equal(got, want)
    t = idx.timer
    for name in ("rows", "count", "count.lookup", "count.reply"):
        assert t.count(name) == 1, name
    assert t.count("aux") == 0
    assert t.total("count.lookup") + t.total("count.reply") <= \
        t.total("count")


def test_phase_ranges_nest_as_the_timer_says(reads):
    """In the trace of a count index's count(), "count.lookup" and
    "count.reply" lie inside "count", and "rows" before it."""
    path, queries = reads
    idx = FAMILIES["count"]()
    idx.build(str(path))
    idx.count(queries)
    _, ranges = profiled(lambda: idx.count(queries))
    by = {n[len(RANGE_PREFIX):]: (lo, hi) for n, lo, hi in ranges}
    assert set(by) == {"rows", "count", "count.lookup", "count.reply"}
    lo, hi = by["count"]
    assert by["rows"][1] <= lo
    for child in ("count.lookup", "count.reply"):
        assert lo <= by[child][0] <= by[child][1] <= hi
    assert by["count.lookup"][1] <= by["count.reply"][0]
