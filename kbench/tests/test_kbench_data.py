"""The seeded inputs, the query packing and the frozen yardsticks."""

import hashlib

import numpy as np
import pytest
import torch

from kbench import data, roofline
from kbench.reference import kmers as ref
from kbench.trace import TraceView, union_length


def fastq_digest(tmp_path, seed, name):
    codes = data.make_reads(5_000, 200, seed, 101)
    quals = data.make_quals(codes, seed)
    path = tmp_path / name
    data.write_fastq(codes, quals, path)
    return hashlib.sha256(path.read_bytes()).hexdigest()


def test_same_seed_same_bytes(tmp_path):
    big = 3_000_000_001
    assert fastq_digest(tmp_path, big, "a") == fastq_digest(tmp_path, big, "b")
    assert fastq_digest(tmp_path, big, "a") != fastq_digest(
        tmp_path, big + 1, "c")


def test_fastq_layout(tmp_path):
    codes = data.make_reads(2_000, 3, 7, 101)
    quals = data.make_quals(codes, 7)
    path = tmp_path / "r.fastq"
    data.write_fastq(codes, quals, path)
    lines = path.read_text().splitlines()
    assert lines[0] == "@r0000000" and lines[4] == "@r0000001"
    assert lines[1] == "".join("ACGTN"[c] for c in codes[0])
    assert lines[3] == "".join(chr(33 + q) for q in quals[0])
    assert path.stat().st_size == 3 * data.record_bytes(101)


def test_make_reads_matches_the_original_draws():
    """read_len=150 and the default rates draw what chip_smoke.py did:
    the same genome windows, flips, substitutions and N."""
    codes = data.make_reads(10_000, 50, 3, 150)
    rng = np.random.default_rng(3)
    genome = rng.integers(0, 4, 10_000, dtype=np.uint8)
    start = rng.integers(0, 10_000 - 150 + 1, 50)
    flip = rng.random(50) < 0.5
    clean = np.where(codes == 4, -1, codes)
    want = genome[start[:, None] + np.arange(150)]
    want[flip] = 3 - want[flip, ::-1]
    same = (clean == want) | (clean < 0)
    assert same.mean() > 0.99


def test_pack_windows_and_codes_round_trip():
    codes = data.make_reads(3_000, 20, 5, 101)
    rows = data.pack_windows(codes, 31, "cpu")
    assert rows.shape == (20 * 71, 2)
    fwd = data.words_to_codes(rows, 31)
    assert np.array_equal(data.codes_to_words(fwd, 31), rows)
    want = []
    for r in codes:
        s = np.where(r == 4, 0, r).astype(np.int64)
        for j in range(71):
            v = 0
            for c in s[j:j + 31]:
                v = v * 4 + int(c)
            want.append(v)
    assert np.array_equal(fwd, np.array(want))
    canon = ref.canonical_codes(codes, 31, "cpu").numpy()
    assert np.all(canon <= fwd)


def test_reference_quality_and_ids():
    quals = torch.tensor([[40] * 31 + [0], [10] * 32], dtype=torch.uint8)
    q = ref.window_quality(quals, 31)
    p40 = 1 - 10 ** -4.0
    assert q[0, 0].item() == pytest.approx(p40 ** 31, rel=1e-12)
    assert q[0, 1].item() == 0.0
    assert q[1, 1].item() == pytest.approx(0.9 ** 31, rel=1e-12)


def test_kernel_bytes_frozen():
    assert roofline.kernel_bytes("extract_canonical", n=10, nwords=2) == 100
    assert roofline.kernel_bytes("merge_runs_cols", na=4, nb=4, n_out=8,
                                 w=2, npay=1) == 16 * 12
    assert roofline.bound_ms(3.35e9) == pytest.approx(1.0)


def synthetic_trace():
    ev = [
        {"cat": "user_annotation", "name": "build", "ts": 0, "dur": 100,
         "tid": 1},
        {"cat": "user_annotation", "name": "first_query", "ts": 100,
         "dur": 20, "tid": 1},
        {"cat": "cpu_op", "name": "aten::copy_", "ts": 10, "dur": 30,
         "tid": 1},
        {"cat": "kernel", "name": "void extract_rolling_kernel<R64>()",
         "ts": 20, "dur": 10},
        {"cat": "kernel", "name": "DeviceRadixSortOnesweepKernel",
         "ts": 25, "dur": 15},
        {"cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable -> Device)",
         "ts": 50, "dur": 20, "args": {"bytes": 2_000_000}},
        {"cat": "kernel", "name": "other", "ts": 110, "dur": 30},
    ]
    return TraceView({"traceEvents": ev}, ("build", "first_query"))


def test_trace_view_arithmetic():
    t = synthetic_trace()
    assert (t.lo, t.hi) == (0, 120)
    assert t.busy_us() == union_length([(20, 40), (50, 70), (110, 120)])
    assert t.busy_us() == 50
    assert t.kernel_us(r"\bextract_(rolling|wide)_kernel\b") == 10
    assert t.kernel_count() == 3
    assert t.memcpy("HtoD") == (2_000_000, 20)
    b = t.breakdown()
    assert b["device_ops"][0][0] == "Memcpy HtoD (Pageable -> Device)"
    gaps = dict(b["idle_gaps"])
    assert set(gaps) == {"build/aten::copy_", "build"}
    assert gaps["build/aten::copy_"] == pytest.approx(20e-6)
    assert gaps["build"] == pytest.approx(50e-6)


def test_idle_gaps_are_named_by_the_innermost_program_range():
    """A made-up build: the main thread waits in the program's feed_wait
    (no host op), then copies in h2d, then flushes; the feeding thread's
    range and a range the run did not open name nothing and bound
    nothing."""
    ev = [
        {"cat": "user_annotation", "name": "build", "ts": 0, "dur": 100,
         "tid": 1},
        {"cat": "user_annotation", "name": "kmerind/feed_wait", "ts": 0,
         "dur": 40, "tid": 1},
        {"cat": "user_annotation", "name": "kmerind/h2d", "ts": 40,
         "dur": 20, "tid": 1},
        {"cat": "cpu_op", "name": "aten::copy_", "ts": 42, "dur": 10,
         "tid": 1},
        {"cat": "user_annotation", "name": "kmerind/flush", "ts": 60,
         "dur": 30, "tid": 1},
        {"cat": "user_annotation", "name": "kmerind/merge", "ts": 65,
         "dur": 25, "tid": 1},
        {"cat": "user_annotation", "name": "kmerind/marshal", "ts": 0,
         "dur": 100, "tid": 2},
        {"cat": "user_annotation", "name": "warm_up", "ts": -50,
         "dur": 200, "tid": 1},
        {"cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable -> Device)",
         "ts": 52, "dur": 8, "args": {"bytes": 800}},
        {"cat": "kernel", "name": "merge_tiles_kernel", "ts": 60,
         "dur": 10},
    ]
    t = TraceView({"traceEvents": ev}, ("build",))
    assert (t.lo, t.hi) == (0, 100)
    gaps = dict(t.breakdown()["idle_gaps"])
    assert gaps == pytest.approx({
        "build/kmerind/feed_wait": 52e-6,       # idle 0-52, middle 26
        "build/kmerind/merge": 30e-6})          # 70-100, middle 85
    assert max(gaps, key=gaps.get) == "build/kmerind/feed_wait"


def test_the_window_is_bounded_by_the_ranges_the_run_opened():
    ev = [{"cat": "user_annotation", "name": "sorted_batch", "ts": 10,
           "dur": 20, "tid": 1},
          {"cat": "user_annotation", "name": "sorted_batch", "ts": 40,
           "dur": 20, "tid": 1},
          {"cat": "kernel", "name": "k", "ts": 0, "dur": 100}]
    for ranges, window in ((("sorted_batch",), (10, 60)), ((), (0, 0)),
                           (("count_batch",), (0, 0))):
        t = TraceView({"traceEvents": ev}, ranges)
        assert (t.lo, t.hi) == window
        assert t.busy_us() == window[1] - window[0]


def test_kernel_calls_record_card_shapes_and_restore():
    from types import SimpleNamespace

    from kbench.harness import KernelCalls

    def t(*shape, dev="cuda"):
        return SimpleNamespace(shape=shape, device=SimpleNamespace(type=dev))
    fake = SimpleNamespace(
        extract_canonical=lambda codes, spec: (t(codes.shape[0], 2), None),
        merge_runs_cols=lambda a, pa, b, pb: ((t(2, 16), ())))
    real = (fake.extract_canonical, fake.merge_runs_cols)
    with KernelCalls(fake) as calls:
        fake.extract_canonical(t(100), SimpleNamespace(nwords=2))
        fake.extract_canonical(t(100, dev="cpu"), SimpleNamespace(nwords=2))
        fake.merge_runs_cols(t(2, 5), (t(5),), t(2, 7), (t(7),))
    assert calls.calls == {
        "extract_canonical": [{"n": 100, "nwords": 2}],
        "merge_runs_cols": [{"na": 5, "nb": 7, "n_out": 16, "w": 2,
                             "npay": 1}]}
    assert (fake.extract_canonical, fake.merge_runs_cols) == real
