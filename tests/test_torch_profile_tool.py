"""The device-busy measure of tools/profile_p4.py: device work that overlaps
counts once, and only device items inside the phase's range count."""

import pathlib
import sys

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
    }
    got = profile_p4.port_kernel_ms(by_name)
    assert got == {"extract_canonical": 0.0, "merge_runs_cols": 1.0,
                   "prefix_sum_i32": 0.5, "run_length_weights": 0.002}
