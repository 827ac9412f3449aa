"""The port's `DeBruijnGraph` against the plain PyTorch reference of its
node counters (``tests/plain_debruijn.py``), exactly, on the CPU.

The reads come from the benchmark's generator (``kbench/data.py``): half
reverse-complemented, with substitutions and 'N's, written as FASTQ and
built through the public API, whole and in chunks small enough that many
chunk halos are crossed and runs merge.  Also: the benchmark's frozen
copy of the reference (``kbench/reference/debruijn.py``) gives the same
counters, and a node query's spans ("rows", "query", "query.lookup",
"query.lookup.run" once per run, "query.reply", "aux" on a cache miss)
nest as named."""

import json
import pathlib
import sys
import tempfile

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import kmerind_tpu_torch as kt  # noqa: E402
from kbench import data  # noqa: E402
from kbench.reference import debruijn as frozen  # noqa: E402
from kmerind_tpu_torch.utils.timers import RANGE_PREFIX  # noqa: E402

import plain_debruijn as plain  # noqa: E402

#: 101-bp reads of a 3 kbp genome, 2 % N (many reads hold one or more)
READS = {"genome_len": 3_000, "n_reads": 240, "read_len": 101,
         "sub_rate": 0.01, "n_rate": 0.02}
HELD = 16
#: chunk sizes: the default (one chunk) and ~40 bases past three k-mers
CHUNKS = {"whole": None, "chunked": 1 << 11}


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    """(FASTQ path, the reads' codes, held-out reads' codes)."""
    r = READS
    codes = data.make_reads(r["genome_len"], r["n_reads"] + HELD, 21,
                            r["read_len"], r["sub_rate"], r["n_rate"])
    main, held = codes[:r["n_reads"]], codes[r["n_reads"]:]
    assert (main == 4).any(1).mean() > 0.5
    path = tmp_path_factory.mktemp("debruijn_plain") / "reads.fastq"
    data.write_fastq(main, data.make_quals(main, 21), path)
    return path, main, held


def built(path, k, chunk_bases=None, max_runs=8):
    g = kt.DeBruijnGraph(kt.KmerSpec(k, kt.DNA), device="cpu",
                         canonical=True, nparts=1, max_runs=max_runs)
    if chunk_bases is not None:
        g.default_chunk_bases = chunk_bases
    return g.build(str(path))


@pytest.mark.parametrize("chunks", list(CHUNKS))
@pytest.mark.parametrize("k", [21, 31])
def test_nodes_and_queries_equal_the_plain_reference(reads, k, chunks):
    path, main, held = reads
    g = built(path, k, CHUNKS[chunks], max_runs=2)
    keys, table = plain.node_table(main, k, "cpu")
    # node queries first: the windows of held-out reads, found or not,
    # and random nodes, nearly all absent
    rng = np.random.default_rng(k)
    absent = torch.from_numpy(rng.integers(0, 1 << (2 * k), 500))
    queries = torch.cat([plain.canonical_codes(held, k, "cpu"), absent,
                         keys[:50]])
    counts, found = g.node_counts(data.codes_to_words(queries.numpy(), k))
    want_c, want_f = plain.node_counts(keys, table, queries)
    assert 0 < want_f.sum() < want_f.numel()
    np.testing.assert_array_equal(counts, want_c.numpy())
    np.testing.assert_array_equal(found, want_f.numpy())
    # then every node the graph holds
    words, vecs = g.items()
    got = data.words_to_codes(words, k)
    order = np.argsort(got)
    np.testing.assert_array_equal(got[order], keys.numpy())
    np.testing.assert_array_equal(vecs[order], table.numpy())
    assert (table[:, :8] > 0).any(0).all(), "every edge counter is reached"


def test_n_neighbours_and_record_ends(reads):
    """The counters the rules single out: an N neighbour sets all four
    bits, a record's end sets none, and the reference's N-as-A control
    differs from it exactly there."""
    _, main, _ = reads
    k = 31
    keys, table = plain.node_table(main, k, "cpu")
    lossy_keys, lossy = plain.node_table(main, k, "cpu", n_edge=0x1)
    assert torch.equal(keys, lossy_keys)
    assert (lossy[:, 8] == table[:, 8]).all()
    assert (lossy[:, :8] <= table[:, :8]).all()
    assert (lossy != table).any(1).sum() > 0
    # out + in edges of a node: at most 4 each per window, and each window
    # but a read's first and last adds at least one of each
    assert (table[:, :4].sum(1) <= 4 * table[:, 8]).all()
    assert (table[:, 4:8].sum(1) <= 4 * table[:, 8]).all()
    ends = 2 * main.shape[0]
    edges = int(table[:, :8].sum())
    assert edges >= 2 * int(table[:, 8].sum()) - ends


@pytest.mark.parametrize("n_edge", [0xF, 0x1])
def test_frozen_copy_gives_the_same_counters(reads, n_edge):
    _, main, held = reads
    for k in (21, 31):
        keys, table = plain.node_table(main, k, "cpu", n_edge=n_edge)
        fkeys, ftable = frozen.node_table(main, k, "cpu", n_edge=n_edge)
        assert torch.equal(keys, fkeys) and torch.equal(table, ftable)
        q = plain.canonical_codes(held, k, "cpu")
        assert torch.equal(q, frozen.canonical_codes(held, k, "cpu"))
        for a, b in zip(plain.node_counts(keys, table, q),
                        frozen.node_counts(fkeys, ftable, q)):
            assert torch.equal(a, b)


def test_node_query_phases_count_the_runs(reads):
    """The first node query builds each run's aux once ("aux" per run);
    every query then enters "rows", "query", "query.lookup" and
    "query.reply" once, and "query.lookup.run" once per run."""
    path, _, held = reads
    g = built(path, 31, CHUNKS["chunked"], max_runs=3)
    runs = len(g.runs)
    assert runs > 1
    q = data.pack_windows(held, 31, "cpu")
    g.timer.clear()
    first = g.node_counts(q)
    t = g.timer
    assert t.count("aux") == runs
    assert t.count("query.lookup.run") == runs
    t.clear()
    again = g.node_counts(q)
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a, b)
    for name in ("rows", "query", "query.lookup", "query.reply"):
        assert t.count(name) == 1, name
    assert t.count("aux") == 0, "a cached aux is no span"
    assert t.count("query.lookup.run") == runs
    assert t.total("query.lookup.run") <= t.total("query.lookup")
    assert t.total("query.lookup") + t.total("query.reply") <= \
        t.total("query")


def test_node_query_ranges_nest_as_named(reads):
    path, _, held = reads
    g = built(path, 31, CHUNKS["chunked"], max_runs=3)
    q = data.pack_windows(held, 31, "cpu")
    g.node_counts(q)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        g.node_counts(q)
    with tempfile.TemporaryDirectory() as tmp:
        trace = pathlib.Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(trace))
        events = json.loads(trace.read_text())["traceEvents"]
    spans = [(ev["name"][len(RANGE_PREFIX):], float(ev["ts"]),
              float(ev["ts"] + ev["dur"])) for ev in events
             if ev.get("cat") == "user_annotation"
             and ev["name"].startswith(RANGE_PREFIX)]
    by = {}
    for name, lo, hi in spans:
        by.setdefault(name, []).append((lo, hi))
    assert set(by) == {"rows", "query", "query.lookup", "query.lookup.run",
                       "query.reply"}
    assert len(by["query.lookup.run"]) == len(g.runs)
    (qlo, qhi), = by["query"]
    (llo, lhi), = by["query.lookup"]
    (rlo, rhi), = by["query.reply"]
    assert by["rows"][0][1] <= qlo
    assert qlo <= llo <= lhi <= rlo <= rhi <= qhi
    for lo, hi in by["query.lookup.run"]:
        assert llo <= lo <= hi <= lhi
