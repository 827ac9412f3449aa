"""The byte counts behind chip_smoke.py's kernel bounds: each input read
once and each output written once, from the shapes of P2's cases; and its
reduction of a profiler trace to device time per call."""

import pathlib
import sys

import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402

CHUNK = chip_smoke.CHUNK


@pytest.mark.parametrize("kname,shape,want", [
    # K1, k=21 DNA: 8.4 MB of codes in, 67.1 MB of words + 8.4 MB of flags out
    ("extract_canonical", dict(n=CHUNK, nwords=2), CHUNK * 10),
    # K2 CHUNK + CHUNK keys only: 134,218,048 in + 268,435,456 out
    ("merge_runs_cols", dict(na=CHUNK, nb=CHUNK, n_out=1 << 25, w=2, npay=0),
     402_653_504),
    ("merge_runs_cols", dict(na=1 << 26, nb=CHUNK, n_out=1 << 27, w=2,
                             npay=0), ((1 << 26) + CHUNK + (1 << 27)) * 8),
    ("merge_runs_cols", dict(na=CHUNK, nb=CHUNK, n_out=1 << 25, w=2, npay=1),
     201_327_072 + 402_653_184),
    # the multimap flush: 2 key words + 3 payloads (id halves, quality)
    ("merge_runs_cols", dict(na=1 << 26, nb=1 << 24, n_out=1 << 27, w=2,
                             npay=3), ((1 << 26) + (1 << 24) + (1 << 27)) * 20),
    # the flagged flush: a flag column + 2 key words + 3 payloads
    ("merge_runs_cols", dict(na=1 << 26, nb=1 << 24, n_out=1 << 27, w=3,
                             npay=3), ((1 << 26) + (1 << 24) + (1 << 27)) * 24),
    ("merge_sorted_runs", dict(na=3, nb=5, n_out=8, w=5, npay=3),
     (3 + 5 + 8) * 32),
    # P7's shapes: k=127 merges (8 key words) and flushes (+ 3 payloads),
    # and DNA k=512 full words behind the flag with 4 payloads
    ("merge_runs_cols", dict(na=CHUNK, nb=CHUNK, n_out=1 << 25, w=8,
                             npay=0), 1_610_614_016),
    ("merge_runs_cols", dict(na=1 << 26, nb=1 << 24, n_out=1 << 27, w=8,
                             npay=3), 9_596_567_552),
    ("merge_runs_cols", dict(na=1 << 22, nb=1 << 22, n_out=1 << 23, w=33,
                             npay=4), 2_483_027_968),
    # K2′ on row-major [n, w] runs: the same bytes as the column layout
    ("merge_sorted_runs", dict(na=CHUNK, nb=CHUNK, n_out=1 << 25, w=2,
                               npay=1), 603_980_256),
    ("merge_sorted_runs", dict(na=CHUNK, nb=CHUNK, n_out=1 << 25, w=8,
                               npay=1), 1_811_940_768),
    # the one-run bitonic merges: a [2^24, 2] run + 1 payload, n rows in
    # and n out (402,653,184 bytes, 0.1202 ms), either layout
    ("bitonic_merge_rows", dict(n=1 << 24, w=2, npay=1), 402_653_184),
    ("bitonic_merge_cols", dict(n=1 << 24, w=2, npay=1), 402_653_184),
    ("bitonic_merge_cols", dict(n=2, w=9, npay=3), 2 * 2 * 48),
    # K1's wide kernel, k=127 DNA: 8 words a window
    ("extract_canonical", dict(n=CHUNK, nwords=8), 285_213_352),
    # K2 with an empty run: the sentinel rows are still written
    ("merge_runs_cols", dict(na=0, nb=0, n_out=2, w=1, npay=0), 8),
    # K3 at 2^28: 2^31 bytes
    ("prefix_sum_i32", dict(n=1 << 28), 1 << 31),
    ("prefix_sum_i32", dict(n=1), 8),
    # K4, w=2: 67.1 MB of keys + the valid count in, 33.6 MB of weights out
    ("run_length_weights", dict(n=CHUNK, w=2), CHUNK * 12 + 4),
])
def test_kernel_bytes(kname, shape, want):
    assert chip_smoke.kernel_bytes(kname, **shape) == want


def test_bound_ms_is_bytes_over_the_hbm_rate():
    assert chip_smoke.HBM_BYTES_PER_S == 3.35e12
    assert chip_smoke.bound_ms(3_350_000_000) == pytest.approx(1.0)
    # K3 at 2^28 and K2 CHUNK + CHUNK, as PERF.md's table states them
    assert chip_smoke.bound_ms(1 << 31) == pytest.approx(0.641, abs=5e-4)
    assert chip_smoke.bound_ms(402_653_504) == pytest.approx(0.120, abs=5e-4)
    # K1 wide at k=127 and the new K2 shapes, as PERF.md states them
    assert chip_smoke.bound_ms(285_213_352) == pytest.approx(0.0851, abs=5e-5)
    assert chip_smoke.bound_ms(1_610_614_016) == pytest.approx(0.4808,
                                                               abs=5e-5)
    assert chip_smoke.bound_ms(9_596_567_552) == pytest.approx(2.8646,
                                                               abs=5e-5)
    assert chip_smoke.bound_ms(2_483_027_968) == pytest.approx(0.7412,
                                                               abs=5e-5)
    # the one-run bitonic merges' [2^24, 2] + 1 payload case
    assert chip_smoke.bound_ms(402_653_184) == pytest.approx(0.1202,
                                                             abs=5e-5)


def test_kernel_bytes_covers_every_kernel_and_no_other():
    from kmerind_tpu_torch.ops import kernels
    shape = dict(n=4, nwords=1, na=1, nb=1, n_out=2, w=1, npay=0)
    for kname in kernels.KERNELS:
        assert chip_smoke.kernel_bytes(kname, **shape) > 0
    with pytest.raises(KeyError):
        chip_smoke.kernel_bytes("sort", **shape)


def test_per_call_us_from_a_trace():
    """Device us per call from a chrome trace of 3 calls: templated and
    namespaced names reduce to the kernel's name, two launches a call
    count twice, and a dropped launch record does not lower the time."""
    def kernel(name, dur):
        return {"cat": "kernel", "name": name, "dur": dur}
    trace = {"traceEvents": [
        kernel("void (anonymous namespace)::extract_rolling_kernel<(anonymous "
               "namespace)::U64State>(unsigned char const*, long)", 30.0),
        kernel("void (anonymous namespace)::extract_rolling_kernel<(anonymous "
               "namespace)::U64State>(unsigned char const*, long)", 36.0),
        kernel("(anonymous namespace)::rl_tiles(unsigned int const*, int)",
               40.0),
        kernel("rl_tiles(unsigned int const*, int)", 44.0),
        kernel("rl_tiles(unsigned int const*, int)", 42.0),
        kernel("merge_partition_kernel<2>(Cols, long)", 10.0),
        *[kernel("merge_partition_kernel<2>(Cols, long)", 12.0)] * 5,
        {"cat": "gpu_memset", "name": "Memset", "dur": 5.0},
        {"cat": "kernel", "name": "no_duration"},
    ]}
    got = chip_smoke.per_call_us(trace, calls=3)
    assert got == {"extract_rolling_kernel": 33.0, "rl_tiles": 42.0,
                   "merge_partition_kernel": pytest.approx(70 / 6 * 2)}
