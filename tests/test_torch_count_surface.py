"""The count indexes' full surface against the JAX package on the same
synthetic reads: insert, insert_counts, find, erase, histogram,
unique_size, get_multiplicity, exists, empty, clear, reserve, the build
entry points and saturate= on the hash CountIndex; histogram,
unique_size and get_multiplicity on SortedCountIndex.  The JAX indexes run
on the conftest's 8-device CPU mesh, each scenario once (its answers are
cached for both shard counts); the port's hold 1 or 4 shards on the CPU.
Every count, key and histogram: exact equality.  Saturate cases run here
on synthetic input (tests/test_saturate.py reads a fixture outside the
repository)."""

import functools

import jax
import numpy as np
import pytest

import kmerind_tpu as kt
import kmerind_tpu_torch as kp
from kmerind_tpu.index.api import CountIndex as JaxCountIndex
from kmerind_tpu.index.sorted_api import SortedCountIndex as JaxSorted
from kmerind_tpu.io import read_file as jax_read_file
from kmerind_tpu_torch.io import read_file as port_read_file

from torch_parity import write_reads

CHUNK = 4000
SAT = 3
#: explicit counts below, at and above SAT (canonicalised like any query)
EXTRA = (["A" * 21, "AC" * 10 + "A", "GT" * 10 + "G"], [1, 2, 9])


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    """A 1.2 kb genome at ~20x (counts spread from 1 to ~40) and a second
    read set of the same genome."""
    d = tmp_path_factory.mktemp("torch_count_surface")
    seqs = write_reads(d / "a.fastq", 200, 120, 1200, seed=21, n_rate=0.002)
    write_reads(d / "b.fastq", 60, 120, 1200, seed=22)
    return d, tuple(seqs)


def _queries(seqs, seed, k=21, m=300):
    """Read windows (repeats included) and random k-mers, as strings."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(m // 2):
        r = seqs[int(rng.integers(len(seqs)))]
        i = int(rng.integers(len(r) - k + 1))
        out.append(r[i:i + k].replace("N", "A"))
    return out + ["".join(rng.choice(list("ACGT"), k)) for _ in range(m // 2)]


def _jax(path, **kw):
    idx = JaxCountIndex(kt.KmerSpec(21, kt.DNA), max_runs=2, **kw)
    return idx.insert_batch(jax_read_file(path, kt.DNA), chunk_bases=CHUNK)


def _port(path, p, **kw):
    idx = kp.CountIndex(kp.KmerSpec(21, kp.DNA), device="cpu", nparts=p,
                        max_runs=2, **kw)
    return idx.insert_batch(port_read_file(path, kp.DNA), chunk_bases=CHUNK)


# ------------------------------------------------------------ the surface
@functools.lru_cache
def _jax_surface(d, seqs):
    q = _queries(seqs, 1)
    counts = np.random.default_rng(1).integers(0, 1000, len(q))
    gone = q[100:250] + q[100:250]
    idx = _jax(d / "a.fastq")
    idx.insert_counts(q, counts)
    idx.insert(q[:40])
    out = dict(q=q, counts=counts, gone=gone, count=idx.count(q),
               find=idx.find(q), h300=idx.histogram(300),
               h7=idx.histogram(7))
    out.update(erased=idx.erase(gone), after=idx.count(q), size=idx.size(),
               dict=idx.to_dict(), h=idx.histogram())
    return out


@pytest.mark.parametrize("p", [1, 4])
def test_insert_find_erase_histogram_match_jax(reads, p):
    """insert_counts (weighted runs: K3 adoption), insert, find, erase
    (distinct keys over every run, each queried twice), histogram,
    unique_size, get_multiplicity and exists after each."""
    want = _jax_surface(*reads)
    q = want["q"]
    pidx = _port(reads[0] / "a.fastq", p)
    pidx.insert_counts(q, want["counts"])
    pidx.insert(q[:40])
    assert len(pidx.runs) == 2 and not any(pidx._unit)
    np.testing.assert_array_equal(pidx.count(q), want["count"])
    np.testing.assert_array_equal(pidx.get_multiplicity(q[:50]),
                                  want["count"][:50])
    for got, exp in zip(pidx.find(q), want["find"]):
        np.testing.assert_array_equal(got, exp)
    np.testing.assert_array_equal(pidx.histogram(300), want["h300"])
    np.testing.assert_array_equal(pidx.histogram(7), want["h7"])
    assert pidx.erase(want["gone"]) == want["erased"] > 0
    assert pidx.count(want["gone"]).sum() == 0
    np.testing.assert_array_equal(pidx.count(q), want["after"])
    np.testing.assert_array_equal(pidx.exists(q), want["after"] > 0)
    assert pidx.unique_size() == pidx.size() == want["size"]
    assert pidx.to_dict() == want["dict"]
    np.testing.assert_array_equal(pidx.histogram(), want["h"])


@functools.lru_cache
def _jax_erase_build(d, seqs):
    gone = _queries(seqs, 7, m=200)[:100]
    idx = _jax(d / "a.fastq")
    erased = idx.erase(gone)
    idx.insert_batch(jax_read_file(d / "b.fastq", kt.DNA), chunk_bases=CHUNK)
    return gone, erased, idx.count(gone), idx.to_dict()


@pytest.mark.parametrize("p", [1, 4])
def test_erase_then_build_then_merge(reads, p):
    """Erased rows keep their keys with weight 0 and clear the unit flag;
    runs built after the erase merge with them weighted (K2 carrying the
    weights), so erased k-mers stay erased and count only their new
    occurrences."""
    d, seqs = reads
    gone, erased, counts, contents = _jax_erase_build(*reads)
    pidx = _port(d / "a.fastq", p)
    assert pidx.erase(gone) == erased > 0
    assert not any(pidx._unit)
    pidx.insert_batch(port_read_file(d / "b.fastq", kp.DNA),
                      chunk_bases=CHUNK)
    assert len(pidx.runs) == 2 and pidx.timer.count("merge") >= 5
    only_b = _port(d / "b.fastq", 1)
    np.testing.assert_array_equal(pidx.count(gone), only_b.count(gone))
    np.testing.assert_array_equal(pidx.count(gone), counts)
    assert pidx.to_dict() == contents


@functools.lru_cache
def _jax_dicts(d):
    both = JaxCountIndex(kt.KmerSpec(21, kt.DNA))
    both.build_files([d / "a.fastq", d / "b.fastq"])
    return both.to_dict(), _jax(d / "a.fastq").to_dict()


@pytest.mark.parametrize("p", [1, 4])
def test_container_surface(reads, p):
    """empty, clear, reserve, build_posix / build_mmap / build_mpiio and
    build_files (file_id = position in the list) against the JAX index."""
    d, _ = reads
    both, only_a = _jax_dicts(d)
    pidx = kp.CountIndex(kp.KmerSpec(21, kp.DNA), device="cpu", nparts=p)
    assert pidx.empty()
    pidx.reserve(1 << 16)
    assert pidx.capacity * p >= 1 << 16 and pidx.empty()
    pidx.build_files([d / "a.fastq", d / "b.fastq"])
    assert not pidx.empty() and pidx.to_dict() == both
    cap = pidx.capacity
    pidx.reserve(4 * cap * p)
    assert pidx.capacity == 4 * cap and pidx.to_dict() == both
    for build in (pidx.build_posix, pidx.build_mmap, pidx.build_mpiio):
        pidx.clear()
        assert pidx.empty() and pidx.to_dict() == {}
        assert build(d / "a.fastq") is pidx
        assert pidx.to_dict() == only_a


# ------------------------------------------------------------------ saturate
def _with_extra(idx):
    idx.insert_counts(*EXTRA)
    return idx


@functools.lru_cache
def _jax_saturate(d, seqs):
    q = _queries(seqs, 3)
    idx = _with_extra(_jax(d / "a.fastq", saturate=SAT))
    out = dict(q=q, count=idx.count(q), dict=idx.to_dict(),
               h=idx.histogram(SAT + 2),
               at_sat=sorted(idx.count_if(lambda k, c: c == SAT)),
               find=idx.find(q)[1])
    idx.compact()
    idx.insert_batch(jax_read_file(d / "a.fastq", kt.DNA), chunk_bases=CHUNK)
    out["recompact"] = idx.to_dict()
    row = np.stack([idx.spec.from_string(q[0])])
    idx.insert_counts(row, [100])
    out["row"] = (row, int(idx.count(row)[0]), idx.erase(row))
    return out


@pytest.mark.parametrize("p", [1, 4])
def test_saturate_clamps_every_reader(reads, p):
    """count, items / to_dict, histogram, count_if's counts, find, the
    clamped compaction and inserts after it, erase: the JAX index's answers
    and min(raw, SAT)."""
    d, seqs = reads
    want = _jax_saturate(*reads)
    q = want["q"]
    praw = _with_extra(_port(d / "a.fastq", p))
    raw = praw.to_dict()
    assert max(raw.values()) > SAT > min(raw.values())
    pidx = _with_extra(_port(d / "a.fastq", p, saturate=SAT))
    assert pidx.to_dict() == want["dict"] == {
        k: min(c, SAT) for k, c in raw.items()}
    np.testing.assert_array_equal(pidx.count(q), want["count"])
    np.testing.assert_array_equal(pidx.count(q),
                                  np.minimum(praw.count(q), SAT))
    rows, cnts = pidx.items()
    assert cnts.max() == SAT and rows.shape[0] == len(raw)
    np.testing.assert_array_equal(pidx.histogram(SAT + 2), want["h"])
    assert pidx.count_if(lambda k, c: c > SAT) == []
    assert sorted(pidx.count_if(lambda k, c: c == SAT)) == want["at_sat"]
    np.testing.assert_array_equal(pidx.find(q)[1], want["find"])
    # a clamped compaction rewrites the raw weights; later inserts clamp on
    file_only = _port(d / "a.fastq", 1).to_dict()
    pidx.compact()
    pidx.insert_batch(port_read_file(d / "a.fastq", kp.DNA),
                      chunk_bases=CHUNK)
    assert pidx.to_dict() == want["recompact"] == {
        k: min(min(c, SAT) + file_only.get(k, 0), SAT)
        for k, c in raw.items()}
    row, at_row, erased = want["row"]
    pidx.insert_counts(row, [100])
    assert pidx.count(row)[0] == SAT == at_row
    assert pidx.erase(row) == erased == 1
    assert pidx.count(row)[0] == 0


@functools.lru_cache
def _jax_pressure(d):
    idx = _with_extra(_jax(d / "a.fastq", saturate=SAT))
    idx._ingested_weight = idx._I32_WEIGHT_GUARD
    return idx.insert_batch(jax_read_file(d / "a.fastq", kt.DNA),
                            chunk_bases=CHUNK).to_dict()


@pytest.mark.parametrize("p", [1, 4])
def test_overflow_guard_saturating_clamps(reads, p):
    """Pressure on a saturating map compacts with the clamp instead of
    letting the int32 prefix sums wrap, as the JAX index does."""
    d, _ = reads
    pidx = _with_extra(_port(d / "a.fastq", p, saturate=SAT))
    pidx._ingested_weight = pidx._I32_WEIGHT_GUARD
    pidx.insert_batch(port_read_file(d / "a.fastq", kp.DNA),
                      chunk_bases=CHUNK)
    assert pidx._ingested_weight < pidx._I32_WEIGHT_GUARD
    assert pidx.timer.count("compact") >= 1
    assert pidx.to_dict() == _jax_pressure(d)
    assert max(pidx.to_dict().values()) == SAT


@pytest.mark.parametrize("p", [1, 4])
def test_overflow_guard_plain_raises(reads, p):
    """A plain map raises before its int32 prefix sums can wrap, and stays
    usable; negative counts are refused."""
    d, _ = reads
    pidx = _port(d / "a.fastq", p)
    rows, _ = pidx.items()
    before = pidx.to_dict()
    big = 1 << 29
    pidx.insert_counts(rows[:2], [big, big])
    with pytest.raises(OverflowError):
        pidx.insert_counts(rows[:2], [big, big])
    got = pidx.to_dict()
    for r in rows[:2]:
        key = pidx.spec.to_int(r)
        assert got.pop(key) == before.pop(key) + big
    assert got == before
    with pytest.raises(ValueError, match="non-negative"):
        pidx.insert_counts(rows[:1], [-1])


# ------------------------------------------------------------------ sorted
@functools.lru_cache
def _jax_sorted(d, seqs):
    idx = JaxSorted(kt.KmerSpec(21, kt.DNA))
    for chunk in jax_read_file(d / "a.fastq", kt.DNA).iter_chunks(CHUNK, 20):
        idx.insert_batch(chunk)
        jax.block_until_ready(idx._pending[-1])
    q = _queries(seqs, 4)
    return (q, idx.histogram(), idx.histogram(5), idx.unique_size(),
            idx.get_multiplicity(q), idx.find(q))


@pytest.mark.parametrize("p", [1, 4])
def test_sorted_count_histogram_and_sizes(reads, p):
    """SortedCountIndex: histogram, unique_size, get_multiplicity, find,
    exists, clear and empty against the JAX sorted index (fed one chunk
    per call)."""
    d, _ = reads
    q, h, h5, usize, mult, found = _jax_sorted(*reads)
    pidx = kp.SortedCountIndex(kp.KmerSpec(21, kp.DNA), device="cpu",
                               nparts=p)
    pidx.insert_batch(port_read_file(d / "a.fastq", kp.DNA),
                      chunk_bases=CHUNK)
    np.testing.assert_array_equal(pidx.histogram(), h)
    np.testing.assert_array_equal(pidx.histogram(5), h5)
    assert pidx.unique_size() == usize
    np.testing.assert_array_equal(pidx.get_multiplicity(q), mult)
    for got, exp in zip(pidx.find(q), found):
        np.testing.assert_array_equal(got, exp)
    np.testing.assert_array_equal(pidx.exists(q), mult > 0)
    pidx.clear()
    assert pidx.empty() and pidx.histogram(3).tolist() == [0, 0, 0, 0]
