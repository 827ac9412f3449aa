"""The cells of kmerind's sort-based count map (`rsph45x-k31-sortedmap.build`)
and of `find(with_quality=True)` batches (`rsph45x-k31-pq.find_quality`):
each at a CPU test's size, traced and untraced, reports its metrics; its
control is caught by the numbers it changes, and so are a map that gives
its keys out of order and qualities off by more than their limit (the
planted faults of every cell, these two included, are
``test_kbench_runs.py``'s); the new readers read hand-built observations;
and no file or cell takes a name that ``test_kbench_new_cells.py``
writes."""

import re

import numpy as np
import pytest

from kbench import control, harness, roofline

from .conftest import ROOT

SORTED = "rsph45x-k31-sortedmap.build"
FIND = "rsph45x-k31-pq.find_quality"
CELLS = [SORTED, FIND]
#: the per-layer metrics this pair of cells added, and the one cell each
NEW_METRICS = {"sorted.flush_s_per_gbase": SORTED,
               "sorted.flushes_per_build": SORTED,
               "run_length_weights_roofline": SORTED,
               "find.reply_ms_per_batch": FIND}


def run(cell, tiny, trace=False, seed=3_000_000_029):
    return harness.run_cell(cell, seed, 0.4, trace, device="cpu",
                            overrides=tiny(cell), log=lambda msg: None)


@pytest.mark.parametrize("trace", [False, True], ids=["end_to_end", "traced"])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_reports_its_metrics(cell, tiny, trace):
    res = run(cell, tiny, trace)
    assert res["correct"] is True, res["checks"]
    assert all(c["value"] == 0 for n, c in res["checks"].items()
               if n != "quality_rel_err")
    bench = harness.Bench()
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in bench.metrics_for(cell, kind)}
    if not trace:
        assert set(res["metrics"]) == want
        return
    got = res["metrics"]
    assert set(got) <= want
    if cell == SORTED:
        assert set(res["checks"]) == {"answer_mismatches", "distinct_gap",
                                      "count_mismatches", "order_mismatches"}
        assert got["sorted.flush_s_per_gbase"]["value"] > 0
        assert got["sorted.flushes_per_build"]["value"] == 1.0
        # K1's call shapes are recorded on the card only
        assert "run_length_weights_roofline" not in got
        assert "device_idle_pct.build" in got
    else:
        assert set(res["checks"]) == {"find_pair_mismatches",
                                      "quality_zero_mismatches",
                                      "quality_rel_err"}
        assert got["find.reply_ms_per_batch"]["value"] > 0
        assert "device_idle_pct.query" in got


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_caught_by_what_it_changes(cell, tiny):
    checks = {n: (v, lim) for n, v, lim in control.control_checks(
        cell, 5, "cpu", overrides=tiny(cell))}
    caught = {n for n, (v, lim) in checks.items() if v > lim}
    if cell == SORTED:
        # low-32 keys: colliding k-mers share a count; the keys stay sorted
        assert {"answer_mismatches", "count_mismatches"} <= caught
        assert checks["order_mismatches"][0] == 0
    else:
        assert caught == {"quality_rel_err"}


def test_keys_out_of_order_are_caught(tiny, monkeypatch):
    """items() with two neighbouring keys swapped: the same contents, so
    only order_mismatches sees it."""
    import kmerind_tpu_torch as kt
    real = kt.SortedCountIndex.items

    def swapped(self):
        w, c = real(self)
        w, c = w.copy(), c.copy()
        w[[3, 4]], c[[3, 4]] = w[[4, 3]], c[[4, 3]]
        return w, c
    monkeypatch.setattr(kt.SortedCountIndex, "items", swapped)
    res = run(SORTED, tiny)
    assert res["correct"] is False
    assert {n for n, c in res["checks"].items() if c["value"] > c["limit"]} \
        == {"order_mismatches"}
    assert res["checks"]["order_mismatches"]["value"] == 2


def test_a_quality_off_by_more_than_its_limit_is_caught(tiny, monkeypatch):
    import kmerind_tpu_torch as kt
    real = kt.PositionQualityIndex.find

    def scaled(self, *a, **kw):
        ids, quals, mask = real(self, *a, **kw)
        return ids, quals * np.float32(1 + 3e-4), mask
    monkeypatch.setattr(kt.PositionQualityIndex, "find", scaled)
    res = run(FIND, tiny)
    assert res["correct"] is False
    assert res["checks"]["find_pair_mismatches"]["value"] == 0
    assert res["checks"]["quality_rel_err"]["value"] > 2e-4


class FakeTrace:
    """`TraceView.kernel_us` over {kernel name: device us}."""

    def __init__(self, kernels: dict):
        self.kernels = kernels

    def kernel_us(self, pattern: str) -> float:
        return sum(us for name, us in self.kernels.items()
                   if re.search(pattern, name))


def observations(calls=4, bases=2_000_000_000, phases=None, counts=None,
                 trace=None, kernel_calls=None):
    win = harness.Window(start=0.0, calls=[(0.0, 1.0, 10)] * calls)
    return harness.Observations(win, 1.0, 0, bases=bases, trace=trace,
                                phases=phases or {}, counts=counts or {},
                                kernel_calls=kernel_calls or {})


def read(name, obs):
    return harness.Bench().metric(name).read(obs)


def test_span_and_counter_readers():
    obs = observations(phases={"sorted.flush": 3.0, "flush": 9.0,
                               "find.reply": 0.2, "find": 7.0},
                       counts={"phases": {"sorted.flush": 6, "flush": 9}})
    assert read("sorted.flush_s_per_gbase", obs) == 1.5
    assert read("find.reply_ms_per_batch", obs) == 50.0
    assert read("sorted.flushes_per_build", obs) == 1.5
    empty = observations(phases={"flush": 1.0},
                         counts={"phases": {"flush": 3}})
    for name in ("sorted.flush_s_per_gbase", "find.reply_ms_per_batch",
                 "sorted.flushes_per_build"):
        assert read(name, empty) is None
        assert read(name, observations(calls=0, bases=0)) is None


def test_k4_roofline_reads_only_where_k1_and_k4_pair():
    n, chunks = 1 << 23, 3
    calls = {"extract_canonical": [{"n": n, "nwords": 2}] * chunks}
    trace = FakeTrace({"rl_tiles(unsigned int const*, int, long)": 150.0,
                       "rl_carry(long const*, long const*, long, int*)": 30.0,
                       "extract_rolling_kernel<2>": 99.0})

    def obs(k1, k4, kernel_calls=calls, tr=trace):
        return observations(counts={"launches": {
            "extract_canonical": k1, "run_length_weights": k4}},
            trace=tr, kernel_calls=kernel_calls)

    bound = roofline.bound_ms(chunks * roofline.kernel_bytes(
        "run_length_weights", n=n, w=2))
    got = read("run_length_weights_roofline", obs(chunks, chunks))
    assert got == pytest.approx(100.0 * bound / 0.18)
    assert 0 < got <= 100
    assert read("run_length_weights_roofline", obs(chunks, 0)) is None
    assert read("run_length_weights_roofline", obs(chunks, 2 * chunks)) \
        is None
    assert read("run_length_weights_roofline", obs(chunks + 1, chunks + 1)) \
        is None, "a K1 call whose shape was not recorded"
    assert read("run_length_weights_roofline",
                obs(chunks, chunks, tr=None)) is None
    assert read("run_length_weights_roofline",
                obs(chunks, chunks, tr=FakeTrace({}))) is None


def test_entries_list_the_cells_their_readers_read():
    spec = harness.Bench().spec
    by = {m["name"]: m for m in spec["end_to_end"] + spec["per_layer"]}
    for name, cell in NEW_METRICS.items():
        assert by[name]["workloads"] == [cell]
    for name in ("build_kmers_per_s", "io.read_s_per_gbase",
                 "index.marshal_s_per_gbase", "h2d_gb_per_s",
                 "sortops.sort_share_pct", "extract_canonical_roofline",
                 "device_idle_pct.build"):
        assert by[name]["workloads"][-1] == SORTED
    for name in ("query_kmers_per_s", "query_batch_p95_ms",
                 "device_idle_pct.query", "query.launches_per_batch"):
        assert by[name]["workloads"][-1] == FIND
    for name in ("merge_runs_cols_roofline", "index.feed_wait_s_per_gbase",
                 "index.ids_s_per_gbase", "index.h2d_host_s_per_gbase",
                 "index.flush_s_per_gbase"):
        assert SORTED not in by[name]["workloads"]


#: what ``test_kbench_new_cells.py`` writes into its copy of the benchmark
TEMPLATE_FILES = ["configs/rsph45x-k31-sorted.json", "loops/sorted_query.py",
                  "loops/find.py", "traffic/sorted_query.json",
                  "traffic/pq_find.json", "judge/pq_find.py",
                  "metrics/count_phases_per_batch.py"]
TEMPLATE_NAMES = ["rsph45x-k31-sorted", "rsph45x-k31-sorted.query",
                  "rsph45x-k31-pq.find", "sorted_query", "pq_find",
                  "count_phases_per_batch"]


def test_no_name_is_one_the_new_cells_template_writes():
    """The template asserts that none of its files is there before it
    writes it; no configuration, cell, mix or metric takes its names."""
    src = (ROOT / "kbench/tests/test_kbench_new_cells.py").read_text()
    for name in TEMPLATE_FILES + TEMPLATE_NAMES:
        assert f'"{name}"' in src, name
    for rel in TEMPLATE_FILES:
        assert not (ROOT / "kbench" / rel).exists(), rel
    spec = harness.Bench().spec
    ours = {e["name"] for key in ("configs", "workloads", "end_to_end",
                                  "per_layer") for e in spec[key]}
    ours |= {e["traffic"] for e in spec["workloads"]}
    assert not ours & set(TEMPLATE_NAMES)


@pytest.mark.cuda
def test_traced_cells_on_the_card_read_every_new_metric(cuda_device, tiny):
    """On the card K1 and K4 launch once a chunk each, so the K4 roofline
    reads; every new metric reads in its cell."""
    for cell in CELLS:
        res = harness.run_cell(cell, 19, 0.5, True, device=cuda_device,
                               overrides=tiny(cell), log=lambda msg: None)
        assert res["correct"] is True and res["device"]["platform"] == "gpu"
        for name, c in NEW_METRICS.items():
            if c == cell:
                assert res["metrics"][name]["value"] > 0, name
        if cell == SORTED:
            assert res["metrics"]["run_length_weights_roofline"]["value"] \
                <= 100
