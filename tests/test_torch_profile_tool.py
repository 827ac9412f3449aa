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


def test_inner_report_reads_the_runs_own_phase_ranges(capsys):
    """The index's "kmerind/<phase>" ranges inside the run's "<run>:<name>"
    ranges, and no other run's."""
    ann = "user_annotation"
    trace = {"traceEvents": [
        {"cat": ann, "name": "p9:build", "ts": 0, "dur": 100},
        {"cat": ann, "name": "kmerind/insert", "ts": 10, "dur": 20},
        {"cat": ann, "name": "kmerind/insert", "ts": 40, "dur": 10},
        {"cat": ann, "name": "kmerind/h2d", "ts": 5, "dur": 5},
        {"cat": "kernel", "name": "k", "ts": 12, "dur": 4},
        {"cat": ann, "name": "p10:build", "ts": 200, "dur": 100},
        {"cat": ann, "name": "kmerind/merge", "ts": 210, "dur": 20},
        {"cat": ann, "name": "p9/insert", "ts": 20, "dur": 5},
    ]}
    got = profile_p4.inner_report("p9", trace, "cpu")
    assert set(got) == {"insert", "h2d"}
    assert got["insert"]["ranges"] == 2
    assert got["insert"]["range_s"] == pytest.approx(30e-6)
    assert got["insert"]["device_busy_s"] == pytest.approx(4e-6)
    assert set(profile_p4.inner_report("p10", trace, "cpu")) == {"merge"}
    assert "P9 index phases [cpu]" in capsys.readouterr().out


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
        "void (anonymous namespace)::run_count_lookup_kernel<2>(unsigned "
        "int const*, long)": 30.0,
        "void (anonymous namespace)::run_vec_lookup_kernel<2, true>(unsigned "
        "int const*, long)": 40.0,
        "void (anonymous namespace)::position_ids_kernel<false, unsigned "
        "short, ushort4>(int const*, unsigned short const*)": 60.0,
        "(anonymous namespace)::min_rep_scan_kernel((anonymous namespace)"
        "::Cols, int*)": 70.0,
        "(anonymous namespace)::min_rep_fill_kernel((anonymous namespace)"
        "::Cols, int*)": 5.0,
    }
    got = profile_p4.port_kernel_ms(by_name)
    assert got == {"extract_canonical": 0.2, "merge_runs_cols": 1.0,
                   "prefix_sum_i32": 0.5, "run_length_weights": 0.002,
                   "run_count_lookup": 0.03, "run_vec_lookup": 0.04,
                   "position_ids": 0.06, "bimol_min_rep": 0.075}


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
    calls = [fn() for fn in steps["p9"].values()]
    assert calls == [("build", "p.fastq"), ("node_counts", "q"),
                     ("node_counts", "q"), ("size",), ("compact",)]
    calls = [fn() for fn in steps["p10"].values()]
    assert calls == [("build", "p.fastq"), ("size",), ("count", "q"),
                     ("count", "q"), ("items",), ("compact",)]
    assert profile_p4.RUN_K == {"p4": 21, "p5": 21, "p6": 21, "p7": 127,
                                "p8": 21, "p9": 21, "p10": 21}


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

    def node_counts(self, queries):
        return ("node_counts", queries)

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


def test_p9_dry_run_on_the_cpu(capsys):
    """--run p9 on the CPU: the de Bruijn graph's phases, and the device
    busy of the graph's own timer phases (each a profiler range)."""
    assert profile_p4.main(["--run", "p9", "--device", "cpu", "--genome",
                            "20000", "--coverage", "2"]) == 0
    out = capsys.readouterr().out
    assert "P9 index phases [cpu]" in out
    record = json.loads(out.strip().splitlines()[-1])
    assert list(record["runs"]) == ["p9", "p9 index phases"]
    assert list(record["runs"]["p9"]) == list(profile_p4.PHASES["p9"])
    inner = record["runs"]["p9 index phases"]
    assert {"insert", "table", "query", "compact"} <= set(inner)
    assert inner["table"]["ranges"] >= 1
    assert all(v["device_busy_s"] == 0.0 for v in inner.values())


def test_p10_dry_run_on_the_cpu(capsys):
    """--run p10 on the CPU: the Bimolecule index's phases, and the device
    busy of its own timer phases (insert, compact, count; one chunk at
    this size, so no merge)."""
    assert profile_p4.main(["--run", "p10", "--device", "cpu", "--genome",
                            "20000", "--coverage", "2"]) == 0
    out = capsys.readouterr().out
    assert "P10 [cpu]" in out and "P10 index phases [cpu]" in out
    record = json.loads(out.strip().splitlines()[-1])
    assert list(record["runs"]) == ["p10", "p10 index phases"]
    assert list(record["runs"]["p10"]) == list(profile_p4.PHASES["p10"])
    inner = record["runs"]["p10 index phases"]
    assert {"insert", "compact", "count"} <= set(inner)
    assert all(v["device_busy_s"] == 0.0 for v in inner.values())


def test_headline_profile_reads_the_last_timed_iteration(capsys):
    """tools/profile_headline.py: the range it reads is the last timed
    iteration of the bench; on the CPU it runs end to end with no device
    time."""
    import profile_headline
    from kmerind_tpu_torch.bench import headline
    trace = {"traceEvents": [
        {"cat": "user_annotation", "name": headline.ITER_RANGE, "ts": 5,
         "dur": 10},
        {"cat": "user_annotation", "name": "other", "ts": 50, "dur": 10},
        {"cat": "user_annotation", "name": headline.ITER_RANGE, "ts": 30,
         "dur": 4},
    ]}
    assert profile_headline.iter_range(trace, headline.ITER_RANGE) == (
        30.0, 34.0)
    with pytest.raises(ValueError):
        profile_headline.iter_range(trace, "missing")
    assert profile_headline.main(
        ["--modes", "e2e,position", "--device", "cpu", "--bases", "4096",
         "--chunks", "2"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out["modes"]) == {"e2e", "position"}
    assert out["modes"]["e2e"]["device_busy_s"] == 0.0
    assert out["modes"]["e2e"]["wall_s"] > 0


@pytest.mark.parametrize("name,want", [
    ("void at::native::index_elementwise_kernel<128, 4, x<y> >(int, z)",
     "index_elementwise_kernel"),
    ("void cub::DeviceRadixSortOnesweepKernel<P, int>(int)",
     "DeviceRadixSortOnesweepKernel"),
    ("(anonymous namespace)::prefix_scan_kernel(unsigned int const*)",
     "prefix_scan_kernel"),
    ("Memcpy DtoD (Device -> Device)", "Memcpy DtoD"),
])
def test_headline_profile_short_names(name, want):
    import profile_headline
    assert profile_headline.short_name(name) == want
