"""The per-layer metrics that read the program's own spans (`PhaseTimer`
phases through the index's `timer=`): each from hand-built observations,
None where its phase is absent, and every one in a tiny traced run of its
cell."""

import pytest

from kbench import harness

#: metric -> (the phase it reads, its cell)
SPANS = {
    "index.feed_wait_s_per_gbase": ("feed_wait", "rsph45x-k31-pq.build"),
    "index.ids_s_per_gbase": ("marshal.ids", "rsph45x-k31-pq.build"),
    "index.h2d_host_s_per_gbase": ("h2d", "rsph45x-k31-pq.build"),
    "index.flush_s_per_gbase": ("flush", "rsph45x-k31-pq.build"),
    "query.rows_ms_per_batch": ("rows", "rsph45x-k31-count.query"),
    "query.lookup_ms_per_batch": ("count.lookup", "rsph45x-k31-count.query"),
    "query.reply_wait_ms_per_batch": ("count.reply",
                                      "rsph45x-k31-count.query"),
}


def observations(phases, calls=4, bases=2_000_000_000):
    win = harness.Window(start=0.0, calls=[(0.0, 1.0, 10)] * calls)
    return harness.Observations(win, 1.0, 0, bases=bases, phases=phases)


@pytest.mark.parametrize("name", list(SPANS))
def test_reader_values(name):
    phase, _ = SPANS[name]
    read = harness.Bench().metric(name).read
    got = read(observations({phase: 3.0, "other": 100.0}))
    # 3 s over 2 Gbase, or 3 s over 4 batches in ms
    assert got == (1.5 if name.startswith("index.") else 750.0)
    assert read(observations({"other": 1.0})) is None
    assert read(observations({phase: 3.0}, calls=0, bases=0)) is None


def test_entries_list_the_cells_the_spans_run_in():
    bench = harness.Bench()
    for m in bench.spec["per_layer"]:
        if m["name"] in SPANS:
            assert m["workloads"] == [SPANS[m["name"]][1]]
            assert m["source"] == "program_span"


@pytest.mark.parametrize("cell", sorted({c for _, c in SPANS.values()}))
def test_traced_run_reports_every_span_metric(cell, tiny):
    res = harness.run_cell(cell, 3_000_000_019, 0.5, True, device="cpu",
                           overrides=tiny(cell), log=lambda msg: None)
    assert res["correct"] is True
    want = {n for n, (_, c) in SPANS.items() if c == cell}
    assert want <= set(res["metrics"])
    for n in want:
        assert res["metrics"][n]["value"] > 0
