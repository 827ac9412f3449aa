"""The Bimolecule build cell: faults planted in the bimolecule judge's
inputs (a flipped orientation, a dropped key, a count off by one, the
last-occurrence control), the correlation matching of a range's
launches, and the new metric readers."""

import numpy as np
import pytest
import torch

from kbench import harness, launches
from kbench.reference import bimolecule as bref

from .conftest import TINY_READS

BIMOL = "rsph45x-k31-bimol.build"


@pytest.fixture(scope="module")
def bimol():
    """(cell, inputs, the reference's outputs as a sound run gives them)."""
    bench = harness.Bench()
    cell = bench.cell(BIMOL, {"reads": TINY_READS})
    inputs = harness.make_inputs(cell.cfg, cell.n_held, 2_147_480_021)
    k, dev = inputs.k, torch.device("cpu")
    keys, counts, strand = bref.table(inputs.codes, k, dev)
    answers = []
    for name, q in cell.judge.query_codes(inputs, cell.sets, dev).items():
        w, c = bref.find(keys, counts, strand, q, k)
        answers.append((name, (w.numpy(), c.numpy())))
    w, c = bref.items(keys, counts, strand, k)
    return cell, inputs, {"answers": answers, "keys": w.numpy(),
                          "counts": c.numpy()}


def judged(cell, inputs, outputs) -> tuple:
    checks = cell.judge.compare(outputs, inputs, cell.sets, 0, "cpu")
    return {n: v for n, v, _ in checks}, all(v <= lim
                                             for _, v, lim in checks)


def copied(outputs):
    return {"answers": [(n, tuple(a.copy() for a in ans))
                        for n, ans in outputs["answers"]],
            "keys": outputs["keys"].copy(),
            "counts": outputs["counts"].copy()}


def test_sound_outputs_pass(bimol):
    cell, inputs, outputs = bimol
    got, ok = judged(cell, inputs, outputs)
    assert ok and set(got) == {"answer_mismatches", "orientation_mismatches",
                               "distinct_gap", "count_mismatches"}
    assert not any(got.values())


def _flip(codes, i, k):
    codes[i] = int(bref.revcomp(torch.tensor([int(codes[i])]), k)[0])


@pytest.mark.parametrize("where", ["answer", "contents"])
def test_one_flipped_orientation_is_caught(bimol, where):
    cell, inputs, outputs = bimol
    out = copied(outputs)
    if where == "answer":
        _flip(out["answers"][0][1][0], 3, inputs.k)
    else:
        _flip(out["keys"], len(out["keys"]) // 2, inputs.k)
    got, ok = judged(cell, inputs, out)
    assert not ok
    assert got["orientation_mismatches"] == 1
    assert got["answer_mismatches"] == got["count_mismatches"] == 0


def test_one_dropped_key_is_caught(bimol):
    cell, inputs, outputs = bimol
    out = copied(outputs)
    keep = np.ones(len(out["keys"]), bool)
    keep[7] = False
    out["keys"], out["counts"] = out["keys"][keep], out["counts"][keep]
    got, ok = judged(cell, inputs, out)
    assert not ok
    assert got["distinct_gap"] == 1 and got["count_mismatches"] == 1


@pytest.mark.parametrize("where", ["answer", "contents"])
def test_one_count_off_by_one_is_caught(bimol, where):
    cell, inputs, outputs = bimol
    out = copied(outputs)
    if where == "answer":
        out["answers"][0][1][1][5] += 1
        want = "answer_mismatches"
    else:
        out["counts"][11] -= 1
        want = "count_mismatches"
    got, ok = judged(cell, inputs, out)
    assert not ok and got[want] == 1
    assert got["orientation_mismatches"] == 0


def test_the_last_occurrence_control_is_caught_by_orientation_alone(bimol):
    cell, inputs, _ = bimol
    out = cell.judge.control(inputs, cell.sets, True, "cpu", 0)
    got, ok = judged(cell, inputs, out)
    assert not ok
    assert got["orientation_mismatches"] > 0
    assert got["answer_mismatches"] == got["distinct_gap"] \
        == got["count_mismatches"] == 0


def _trace(events):
    return {"traceEvents": events}


def test_range_device_us_matches_launches_by_correlation():
    ev = [
        {"cat": "user_annotation", "name": "kmerind/bimol.strands",
         "ts": 100, "dur": 50, "tid": 1},
        {"cat": "user_annotation", "name": "kmerind/other", "ts": 0,
         "dur": 1000, "tid": 1},
        # launched inside the range: counted, wherever they ran
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 110,
         "dur": 5, "tid": 1, "args": {"correlation": 7}},
        {"cat": "cuda_runtime", "name": "cudaMemsetAsync", "ts": 120,
         "dur": 5, "tid": 1, "args": {"correlation": 8}},
        {"cat": "kernel", "name": "k7", "ts": 400, "dur": 30,
         "args": {"correlation": 7}},
        {"cat": "gpu_memset", "name": "m8", "ts": 430, "dur": 2,
         "args": {"correlation": 8}},
        # launched before the range, or on another thread: not counted
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 90,
         "dur": 5, "tid": 1, "args": {"correlation": 6}},
        {"cat": "kernel", "name": "k6", "ts": 120, "dur": 20,
         "args": {"correlation": 6}},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 130,
         "dur": 5, "tid": 2, "args": {"correlation": 9}},
        {"cat": "kernel", "name": "k9", "ts": 135, "dur": 40,
         "args": {"correlation": 9}},
    ]
    got = launches.launch_events(_trace(ev), ["kmerind/bimol.strands"])
    assert launches.range_device_us(got, "kmerind/bimol.strands") == 32.0
    assert launches.range_device_us(got, "kmerind/other") is None
    none = launches.launch_events(_trace(ev[2:]), ["kmerind/bimol.strands"])
    assert launches.range_device_us(none, "kmerind/bimol.strands") is None


def test_range_device_us_adds_ranges_and_counts_a_nested_item_once():
    ev = [
        {"cat": "user_annotation", "name": "kmerind/compact", "ts": 0,
         "dur": 100, "tid": 1},
        {"cat": "user_annotation", "name": "kmerind/bimol.min_rep",
         "ts": 10, "dur": 20, "tid": 1},
        {"cat": "user_annotation", "name": "kmerind/bimol.strands",
         "ts": 200, "dur": 20, "tid": 1},
        {"cat": "cuda_runtime", "ts": 15, "dur": 1, "tid": 1,
         "args": {"correlation": 1}},
        {"cat": "cuda_runtime", "ts": 50, "dur": 1, "tid": 1,
         "args": {"correlation": 2}},
        {"cat": "cuda_runtime", "ts": 205, "dur": 1, "tid": 1,
         "args": {"correlation": 3}},
        {"cat": "kernel", "ts": 300, "dur": 100, "args": {"correlation": 1}},
        {"cat": "kernel", "ts": 400, "dur": 10, "args": {"correlation": 2}},
        {"cat": "kernel", "ts": 500, "dur": 1, "args": {"correlation": 3}},
    ]
    names = ["kmerind/compact", "kmerind/bimol.min_rep",
             "kmerind/bimol.strands"]
    got = launches.launch_events(_trace(ev), names)
    assert launches.range_device_us(got, "kmerind/bimol.min_rep") == 100.0
    assert launches.range_device_us(got, "kmerind/bimol.min_rep",
                                    "kmerind/bimol.strands") == 101.0
    assert launches.range_device_us(got, *names) == 111.0


def observations(phases=None, counts=None, calls=2, bases=4_000_000_000):
    win = harness.Window(start=0.0, calls=[(0.0, 1.0, 10)] * calls)
    return harness.Observations(win, 1.0, 0, bases=bases,
                                phases=phases or {}, counts=counts or {})


class _Busy:
    def __init__(self, us):
        self.us = us

    def busy_us(self):
        return self.us


def test_new_metric_readers():
    bench = harness.Bench()
    read = lambda n, obs: bench.metric(n).read(obs)  # noqa: E731
    assert read("bimol.flush_s_per_gbase",
                observations({"bimol.flush": 3.0, "flush": 9.0})) == 0.75
    assert read("bimol.flush_s_per_gbase", observations({"flush": 1.0})) \
        is None
    assert read("bimol.flushes_per_build", observations(
        counts={"phases": {"bimol.flush": 18}})) == 9.0
    assert read("bimol.flushes_per_build", observations(
        counts={"phases": {"flush": 18}})) is None
    obs = observations()
    obs.window.launches = launches.launch_events(_trace([
        {"cat": "user_annotation", "name": "kmerind/bimol.strands",
         "ts": 0, "dur": 10, "tid": 1},
        {"cat": "cuda_runtime", "ts": 1, "dur": 1, "tid": 1,
         "args": {"correlation": 3}},
        {"cat": "kernel", "ts": 20, "dur": 250, "args": {"correlation": 3}},
    ]), ["kmerind/bimol.strands"])
    assert read("bimol.min_rep_share_pct", obs) is None     # no trace
    obs.trace = _Busy(1000.0)
    assert read("bimol.min_rep_share_pct", obs) == 25.0
    both = observations()
    both.trace = _Busy(1000.0)
    both.window.launches = launches.launch_events(_trace([
        {"cat": "user_annotation", "name": "kmerind/bimol.strands",
         "ts": 0, "dur": 10, "tid": 1},
        {"cat": "user_annotation", "name": "kmerind/bimol.min_rep",
         "ts": 50, "dur": 10, "tid": 1},
        {"cat": "cuda_runtime", "ts": 1, "dur": 1, "tid": 1,
         "args": {"correlation": 3}},
        {"cat": "cuda_runtime", "ts": 51, "dur": 1, "tid": 1,
         "args": {"correlation": 4}},
        {"cat": "kernel", "ts": 20, "dur": 250, "args": {"correlation": 3}},
        {"cat": "kernel", "ts": 300, "dur": 500, "args": {"correlation": 4}},
    ]), ["kmerind/bimol.strands", "kmerind/bimol.min_rep"])
    assert read("bimol.min_rep_share_pct", both) == 75.0
    obs.trace = _Busy(0.0)
    assert read("bimol.min_rep_share_pct", obs) is None
    assert read("bimol.min_rep_share_pct", observations()) is None


def test_traced_run_reports_the_new_span_metrics(tiny):
    res = harness.run_cell(BIMOL, 3_000_000_031, 0.5, True, device="cpu",
                           overrides=tiny(BIMOL), log=lambda msg: None)
    assert res["correct"] is True
    want = {"bimol.flush_s_per_gbase", "bimol.flushes_per_build"}
    assert want <= set(res["metrics"])
    for n in want:
        assert res["metrics"][n]["value"] > 0
    assert res["metrics"]["bimol.flushes_per_build"]["value"] >= 1
