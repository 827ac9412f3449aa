"""The device-busy measure of tools/profile_p4.py: device work that overlaps
counts once, and only device items inside the phase's range count; its P4
and P5 runs name their phases."""

import json
import pathlib
import sys

import numpy as np
import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                       / "tools"))

import profile_p4  # noqa: E402


@pytest.mark.parametrize("intervals,want", [
    ([], 0.0),
    ([(0, 10)], 10.0),
    ([(0, 10), (20, 25)], 15.0),          # disjoint
    ([(0, 10), (5, 15)], 15.0),           # overlapping
    ([(0, 10), (2, 3), (4, 9)], 10.0),    # nested
    ([(10, 20), (0, 10)], 20.0),          # touching, out of order
])
def test_union_length(intervals, want):
    assert profile_p4.union_length(intervals) == want


def test_phase_device_items_clips_to_the_range():
    trace = {"traceEvents": [
        {"cat": "kernel", "name": "k", "ts": 0, "dur": 10},
        {"cat": "kernel", "name": "k", "ts": 5, "dur": 10},
        {"cat": "gpu_memcpy", "name": "HtoD", "ts": 90, "dur": 20},
        {"cat": "gpu_memset", "name": "set", "ts": 200, "dur": 5},
        {"cat": "cpu_op", "name": "aten::sort", "ts": 0, "dur": 100},
        {"cat": "kernel", "name": "no_dur", "ts": 1},
    ]}
    spans, by_name = profile_p4.phase_device_items(trace, 2.0, 100.0)
    assert sorted(spans) == [(2.0, 10.0), (5.0, 15.0), (90.0, 100.0)]
    assert by_name == {"k": 18.0, "HtoD": 10.0}
    assert profile_p4.union_length(spans) == 23.0


def test_port_kernel_ms_sums_each_kernels_launches():
    by_name = {
        "void (anonymous namespace)::merge_partition_kernel<2>(Cols, long)":
            10.0,
        "void (anonymous namespace)::merge_tiles_kernel<2>(Cols, int)": 990.0,
        "(anonymous namespace)::prefix_scan_kernel(unsigned int const*)": 500.0,
        "void at::native::merge_tiles_kernel_other(int)": 7.0,
        "void cub::DeviceRadixSortOnesweepKernel<int>(int)": 3000.0,
        "rl_tiles": 2.0,
        "void (anonymous namespace)::extract_rolling_kernel<(anonymous "
        "namespace)::U64State>(unsigned char const*, long)": 150.0,
        "(anonymous namespace)::extract_wide_kernel(unsigned char const*)":
            50.0,
        "void other::extract_rolling_kernel_v2(int)": 9.0,
    }
    got = profile_p4.port_kernel_ms(by_name)
    assert got == {"extract_canonical": 0.2, "merge_runs_cols": 1.0,
                   "prefix_sum_i32": 0.5, "run_length_weights": 0.002}


def test_phases_of_both_runs():
    """P4 (hash index), P5 (sorted index: build, then the flush) and P6
    (position+quality index: build, the last flush, two finds) each name
    a step for every phase they report."""
    steps = {run: profile_p4.phase_steps(run, _FakeIndex(), "p.fastq", "q")
             for run in profile_p4.PHASES if run != "p8"}
    assert profile_p4.PHASES["p5"] == ("build", "flush", "count1", "count2")
    for run, fns in steps.items():
        assert tuple(fns) == profile_p4.PHASES[run]
    calls = [fn() for fn in steps["p5"].values()]
    assert calls == [("build", "p.fastq"), ("size",), ("count", "q"),
                     ("count", "q")]
    calls = [fn() for fn in steps["p6"].values()]
    assert calls == [("build", "p.fastq"), ("size",), ("find", "q", True),
                     ("find", "q", True)]
    calls = [fn() for fn in steps["p7"].values()]
    assert calls == [("build", "p.fastq"), ("count", "q"), ("count", "q"),
                     ("items",)]
    assert profile_p4.RUN_K == {"p4": 21, "p5": 21, "p6": 21, "p7": 127,
                                "p8": 21}


def test_p8_phases_drive_the_count_surface(tmp_path):
    """P8's steps: the surface calls in order, insert_counts of the first
    half of the queries and as many random rows, erase of the second
    half, the npz beside the FASTQ."""
    queries = np.arange(40, dtype=np.uint32).reshape(20, 2)
    fns = profile_p4.phase_steps("p8", _FakeIndex(), tmp_path / "p.fastq",
                                 queries)
    assert tuple(fns) == profile_p4.PHASES["p8"]
    calls = {name: fn() for name, fn in fns.items()}
    kind, pairs, counts = calls["insert_counts"]
    assert kind == "insert_counts" and pairs.shape == (20, 2)
    np.testing.assert_array_equal(pairs[:10], queries[:10])
    assert counts.shape == (20,) and 1 <= counts.min() <= counts.max() <= 1000
    np.testing.assert_array_equal(calls["erase"][1], queries[10:])
    assert calls["histogram"] == ("histogram", 255)
    assert calls["save"] == ("save", tmp_path / "p8.npz")
    assert [calls[n][0] for n in ("size", "filter", "count_if")] == [
        "size", "filter", "count_if"]


class _FakeIndex:
    """Records which index method a phase calls."""

    def build(self, path):
        return ("build", path)

    def count(self, queries):
        return ("count", queries)

    def find(self, queries, with_quality=False):
        return ("find", queries, with_quality)

    def size(self):
        return ("size",)

    def items(self):
        return ("items",)

    def compact(self):
        return ("compact",)

    def histogram(self, max_count):
        return ("histogram", max_count)

    def insert_counts(self, kmers, counts):
        return ("insert_counts", kmers, counts)

    def erase(self, kmers):
        return ("erase", kmers)

    def filter(self, pred):
        return ("filter", pred)

    def count_if(self, pred):
        return ("count_if", pred)

    def save(self, path):
        return ("save", path)


def test_p5_dry_run_on_the_cpu(capsys):
    """--run p5 on the CPU (no device time): the sorted index's phases, in
    their own table and JSON record, and no P4 run."""
    assert profile_p4.main(["--run", "p5", "--device", "cpu", "--genome",
                            "20000", "--coverage", "2"]) == 0
    out = capsys.readouterr().out
    assert "P5 [cpu]" in out and "P4 [cpu]" not in out
    record = json.loads(out.strip().splitlines()[-1])
    assert list(record["runs"]) == ["p5"]
    assert list(record["runs"]["p5"]) == ["build", "flush", "count1",
                                          "count2"]


def test_p6_dry_run_on_the_cpu(capsys):
    """--run p6 on the CPU: the position+quality index's phases."""
    assert profile_p4.main(["--run", "p6", "--device", "cpu", "--genome",
                            "20000", "--coverage", "2"]) == 0
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(record["runs"]) == ["p6"]
    assert list(record["runs"]["p6"]) == ["insert", "merge", "find1",
                                          "find2"]


def test_p7_dry_run_on_the_cpu(capsys):
    """--run p7 on the CPU: the k = 127 count index's phases."""
    assert profile_p4.main(["--run", "p7", "--device", "cpu", "--genome",
                            "20000", "--coverage", "2"]) == 0
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(record["runs"]) == ["p7"]
    assert list(record["runs"]["p7"]) == ["build", "count1", "count2",
                                          "items"]


def test_p8_dry_run_on_the_cpu(capsys):
    """--run p8 on the CPU: the count surface's phases."""
    assert profile_p4.main(["--run", "p8", "--device", "cpu", "--genome",
                            "20000", "--coverage", "2"]) == 0
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(record["runs"]) == ["p8"]
    assert list(record["runs"]["p8"]) == list(profile_p4.PHASES["p8"])
