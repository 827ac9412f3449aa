"""The per-layer metrics of the de Bruijn graph's node query: the two that
read its spans (`query.lookup`, `query.reply`) and the one that counts its
`query.lookup.run` entries, each from hand-built observations, None where
its phase is absent, and every one in a tiny traced run of its cell."""

import pytest

from kbench import harness

GRAPH = "rsph45x-k31-debruijn.node_query"
#: metric -> (the phase it reads, its source)
METRICS = {
    "debruijn.lookup_ms_per_batch": ("query.lookup", "program_span"),
    "debruijn.reply_wait_ms_per_batch": ("query.reply", "program_span"),
    "debruijn.runs_per_batch": ("query.lookup.run", "program_counter"),
}
SPANS = [n for n, (_, src) in METRICS.items() if src == "program_span"]
COUNTERS = [n for n, (_, src) in METRICS.items() if src == "program_counter"]


def observations(phases=None, calls=4, counts=None):
    win = harness.Window(start=0.0, calls=[(0.0, 1.0, 10)] * calls)
    return harness.Observations(win, 1.0, 0, phases=phases or {},
                                counts=counts or {})


@pytest.mark.parametrize("name", SPANS)
def test_span_reader_values(name):
    phase, _ = METRICS[name]
    read = harness.Bench().metric(name).read
    # 3 s over 4 batches, in ms
    assert read(observations({phase: 3.0, "other": 100.0})) == 750.0
    assert read(observations({"other": 1.0})) is None
    assert read(observations({phase: 3.0}, calls=0)) is None


@pytest.mark.parametrize("name", COUNTERS)
def test_counter_reader_values(name):
    phase, _ = METRICS[name]
    read = harness.Bench().metric(name).read
    # 32 entries over 4 batches
    assert read(observations(counts={"phases": {phase: 32}})) == 8.0
    assert read(observations(counts={"phases": {"x": 1}})) is None
    assert read(observations(calls=0,
                             counts={"phases": {phase: 32}})) is None


def test_entries_list_the_graph_cell():
    bench = harness.Bench()
    got = {m["name"]: m for m in bench.spec["per_layer"]}
    for name, (_, source) in METRICS.items():
        assert got[name]["workloads"] == [GRAPH]
        assert got[name]["source"] == source
        assert got[name]["moves"] == "query_batch_p95_ms"


def test_traced_run_reports_every_graph_metric(tiny):
    res = harness.run_cell(GRAPH, 3_000_000_019, 0.5, True, device="cpu",
                           overrides=tiny(GRAPH), log=lambda msg: None)
    assert res["correct"] is True
    assert set(METRICS) <= set(res["metrics"])
    for n in METRICS:
        assert res["metrics"][n]["value"] > 0
    # one search per run of the tiny graph, which holds at least one run
    assert res["metrics"]["debruijn.runs_per_batch"]["value"] >= 1.0
