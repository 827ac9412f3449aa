"""The port's multimaps — PositionIndex, PositionQualityIndex (hash
partitioned) and SortedPositionIndex, SortedPositionQualityIndex (range
partitioned) — and the multi-shard hash CountIndex against the JAX
package's on the same synthetic reads.  The JAX indexes run on the
conftest's 8-device CPU mesh; the port's hold as many shards stacked on the
CPU.  Chunks are small, so the multimaps hold several pending batches
before a flush.  Ids, counts and sizes: exact equality; qualities: rtol
1e-6 and exactly 0 where the JAX package gives 0.  A multimap keeps no
order within a key, so find answers are compared per query as sorted
lists.

The JAX indexes are fed one chunk per call, each waited for: the JAX
sorted index's multi-chunk `insert_batch` loses k-mers on the CPU backend
(a known reference fault, ROADMAP queue 3)."""

import jax
import numpy as np
import pytest

import kmerind_tpu as kt
import kmerind_tpu_torch as kp
from kmerind_tpu.index import api as japi
from kmerind_tpu.index import sorted_api as jsapi
from kmerind_tpu.io import read_file as jax_read_file
from kmerind_tpu.parallel.mesh import make_mesh
from kmerind_tpu_torch.index.convert import (position_index_from_state,
                                             sorted_position_index_from_state)
from kmerind_tpu_torch.io import read_file as port_read_file

from torch_parity import write_reads

CHUNK = 3000

FAMILIES = {
    "hash": (japi.PositionIndex, kp.PositionIndex),
    "hash_q": (japi.PositionQualityIndex, kp.PositionQualityIndex),
    "sorted": (jsapi.SortedPositionIndex, kp.SortedPositionIndex),
    "sorted_q": (jsapi.SortedPositionQualityIndex,
                 kp.SortedPositionQualityIndex),
}


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    """A 1.5 kb genome at ~8x, FASTQ with varied qualities and the same
    reads as FASTA: keys repeat, so find lists outgrow small widths."""
    d = tmp_path_factory.mktemp("torch_position")
    seqs = write_reads(d / "reads.fastq", 120, 100, 1500, seed=3,
                       n_rate=0.005, varied_quality=True)
    write_reads(d / "reads.fasta", 120, 100, 1500, seed=3, fmt="fasta",
                n_rate=0.005)
    return d, seqs


@pytest.fixture(scope="module")
def long_reads(tmp_path_factory):
    """200 bp reads of a 2 kb genome at ~12x, FASTQ with varied qualities
    and FASTA: room for k = 127 and 128 windows."""
    d = tmp_path_factory.mktemp("torch_position_wide")
    seqs = write_reads(d / "reads.fastq", 120, 200, 2000, seed=13,
                       n_rate=0.005, varied_quality=True)
    write_reads(d / "reads.fasta", 120, 200, 2000, seed=13, fmt="fasta",
                n_rate=0.005)
    return d, seqs


def _pair(family, path, p, k, canonical, id_kind="short"):
    jcls, pcls = FAMILIES[family]
    jidx = jcls(kt.KmerSpec(k, kt.DNA), mesh=make_mesh(p),
                canonical=canonical, id_kind=id_kind)
    for chunk in jax_read_file(path, kt.DNA).iter_chunks(CHUNK, k - 1):
        jidx.insert_batch(chunk)
        jax.block_until_ready(jidx._pending[-1])
    pidx = pcls(kp.KmerSpec(k, kp.DNA), device="cpu", nparts=p,
                canonical=canonical, id_kind=id_kind)
    pidx.insert_batch(port_read_file(path, kp.DNA), chunk_bases=CHUNK)
    return jidx, pidx


def _queries(seqs, rng, k, m=160):
    out = []
    for _ in range(m // 2):
        r = seqs[int(rng.integers(len(seqs)))]
        i = int(rng.integers(len(r) - k + 1))
        out.append(r[i:i + k].replace("N", "A"))
    return out + ["".join(rng.choice(list("ACGT"), k)) for _ in range(m // 2)]


def _assert_quals_close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_array_equal(got == 0, want == 0)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def _assert_same_dict(pd, jd, with_quality):
    if not with_quality:
        assert pd == jd
        return
    assert pd.keys() == jd.keys()
    for key, pairs in jd.items():
        assert [i for i, _ in pd[key]] == [i for i, _ in pairs]
        _assert_quals_close([q for _, q in pd[key]], [q for _, q in pairs])


def _per_query(ids, mask, quals=None):
    """Each query's found (id[, quality]) pairs, sorted."""
    if quals is None:
        return [sorted(ids[i][mask[i]].tolist()) for i in range(len(ids))]
    return [sorted(zip(ids[i][mask[i]].tolist(), quals[i][mask[i]].tolist()))
            for i in range(len(ids))]


def _assert_same_find(got, want, with_quality):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if not with_quality:
            assert g == w
            continue
        assert [i for i, _ in g] == [i for i, _ in w]
        _assert_quals_close([q for _, q in g], [q for _, q in w])


@pytest.mark.parametrize("family,p,k,canonical,fmt", [
    ("hash", 1, 21, False, "fastq"),
    ("hash", 4, 32, False, "fasta"),
    ("hash_q", 4, 21, False, "fastq"),
    ("hash_q", 1, 32, True, "fastq"),
    ("sorted", 1, 32, False, "fasta"),
    ("sorted_q", 4, 21, False, "fastq"),
    ("sorted_q", 4, 32, True, "fastq"),
    ("hash", 2, 80, False, "fastq"),
    ("hash_q", 1, 81, True, "fastq"),
])
def test_position_index_matches_jax(reads, family, p, k, canonical, fmt):
    """to_dict, size, count, find (growing and cut), unique_size and erase;
    k = 32 takes the flagged merge (keys may equal the sentinel), FASTA the
    long ids; k = 80 (the flag plus 5 full words) and k = 81 (6 words) take
    K2 (here its plain version) past 5 key columns."""
    _check_matches_jax(*reads, family, p, k, canonical, fmt)


@pytest.mark.parametrize("family,p,k,canonical,fmt", [
    ("hash", 2, 127, False, "fastq"),
    ("hash_q", 1, 128, True, "fastq"),
    ("sorted", 1, 127, True, "fasta"),
    ("sorted_q", 4, 128, False, "fastq"),
])
def test_position_index_wide_k_matches_jax(long_reads, family, p, k,
                                           canonical, fmt):
    """The same at 8 key words (k = 127) and at 8 full words behind the
    flag (k = 128, 9 key columns in the hash family's merge)."""
    _check_matches_jax(*long_reads, family, p, k, canonical, fmt)


def _check_matches_jax(d, seqs, family, p, k, canonical, fmt):
    id_kind = "short" if fmt == "fastq" else "long"
    jidx, pidx = _pair(family, d / f"reads.{fmt}", p, k, canonical, id_kind)
    wq = pidx.with_quality
    assert len(pidx._pending) == pidx.timer.count("insert") >= 4
    _assert_same_dict(pidx.to_dict(), jidx.to_dict(), wq)
    assert pidx.size() == jidx.size() > 0
    assert pidx.unique_size() == jidx.unique_size() == len(jidx.to_dict())

    q = _queries(seqs, np.random.default_rng(p * 100 + k), k)
    want_counts = jidx.count(q)
    np.testing.assert_array_equal(pidx.count(q), want_counts)
    assert want_counts.max() > 2
    # grow_to_fit: every pair comes back although width 2 is too small
    got = pidx.find(q, max_per_query=2, with_quality=wq)
    want = jidx.find(q, max_per_query=2, with_quality=wq)
    assert got[0].shape[1] > 2
    _assert_same_find(_per_query(got[0], got[-1], got[1] if wq else None),
                      _per_query(want[0], want[-1], want[1] if wq else None),
                      wq)
    # cut at width 2: the true multiplicities come last
    ids, mask, counts = pidx.find(q, max_per_query=2, grow_to_fit=False)
    np.testing.assert_array_equal(counts, want_counts)
    np.testing.assert_array_equal(mask.sum(1), np.minimum(want_counts, 2))
    full = _per_query(got[0], got[-1])
    assert all(set(c) <= set(f) for c, f in zip(_per_query(ids, mask), full))

    assert pidx.erase(q[:60]) == jidx.erase(q[:60]) > 0
    assert pidx.size() == jidx.size()
    np.testing.assert_array_equal(pidx.count(q), jidx.count(q))
    _assert_same_dict(pidx.to_dict(), jidx.to_dict(), wq)


@pytest.mark.parametrize("family,p", [("hash_q", 4), ("sorted_q", 4),
                                      ("hash", 1)])
def test_explicit_insert_matches_jax(reads, family, p):
    """insert(kmers, ids, quals) after a build: the pairs land with their
    ids and qualities, canonicalized like the index's own k-mers."""
    d, seqs = reads
    jidx, pidx = _pair(family, d / "reads.fastq", p, 21, True)
    rng = np.random.default_rng(5)
    kmers = _queries(seqs, rng, 21, m=200)
    ids = rng.integers(0, 2**63, 200, dtype=np.uint64)
    quals = rng.random(200).astype(np.float32)
    pidx.insert(kmers, ids, quals)
    jidx.insert(kmers, ids, quals)
    _assert_same_dict(pidx.to_dict(), jidx.to_dict(), pidx.with_quality)
    np.testing.assert_array_equal(pidx.count(kmers), jidx.count(kmers))
    with pytest.raises(ValueError, match="length mismatch"):
        pidx.insert(kmers, ids[:3])


def test_quals_kept_by_position_index_known_divergence(reads):
    """A PositionIndex without quality stores the quals that
    insert(..., quals=) gives it, through later flushes.  The JAX index
    drops them at its next flush (its merge keeps the old quality column
    while the rows move; ROADMAP queue 3): the ids agree, the qualities do
    not — a known divergence of the reference, kept visible here."""
    d, seqs = reads
    path = d / "reads.fastq"
    spec_j, spec_p = kt.KmerSpec(21, kt.DNA), kp.KmerSpec(21, kp.DNA)
    jidx = japi.PositionIndex(spec_j, mesh=make_mesh(2))
    pidx = kp.PositionIndex(spec_p, device="cpu", nparts=2)
    rng = np.random.default_rng(8)
    kmers = _queries(seqs, rng, 21, m=100)[:50]
    ids = np.arange(50, dtype=np.uint64) + (1 << 60)
    quals = (np.arange(50, dtype=np.float32) + 1) / 64
    for idx in (jidx, pidx):
        idx.insert(kmers, ids, quals)
    for chunk in jax_read_file(path, kt.DNA).iter_chunks(CHUNK, 20):
        jidx.insert_batch(chunk)
    pidx.insert_batch(port_read_file(path, kp.DNA), chunk_bases=CHUNK)
    assert pidx.to_dict() == jidx.to_dict()

    def given_quals(idx):
        found, fq, mask = idx.find(kmers, with_quality=True)
        return {i: q for i, q in zip(found[mask].tolist(), fq[mask].tolist())
                if i >= 1 << 60}

    want = dict(zip(ids.tolist(), quals.tolist()))
    assert given_quals(pidx) == want
    assert given_quals(jidx) != want          # the reference fault


@pytest.mark.parametrize("sorted_family", [False, True])
def test_convert_jax_state(reads, sorted_family):
    """A flushed JAX index's store (and splitters) carried across answer
    find and count the same, without a flush of the port's index."""
    d, seqs = reads
    family = "sorted_q" if sorted_family else "hash_q"
    jcls, _ = FAMILIES[family]
    jidx = jcls(kt.KmerSpec(21, kt.DNA), mesh=make_mesh(4), canonical=True)
    for chunk in jax_read_file(d / "reads.fastq", kt.DNA).iter_chunks(
            CHUNK, 20):
        jidx.insert_batch(chunk)
        jax.block_until_ready(jidx._pending[-1])
    jidx._flush()
    s = jidx.store
    state = [np.asarray(x) for x in (s.keys, s.val_hi, s.val_lo, s.val_q,
                                     s.size)]
    spec = kp.KmerSpec(21, kp.DNA)
    if sorted_family:
        pidx = sorted_position_index_from_state(
            *state, np.asarray(jidx.splitters), spec, "cpu", canonical=True,
            with_quality=True)
        assert isinstance(pidx, kp.SortedPositionQualityIndex)
    else:
        pidx = position_index_from_state(*state, spec, "cpu", canonical=True,
                                         with_quality=True)
        assert isinstance(pidx, kp.PositionQualityIndex)
    q = _queries(seqs, np.random.default_rng(9), 21, m=400)
    np.testing.assert_array_equal(pidx.count(q), jidx.count(q))
    got, want = (x.find(q, with_quality=True) for x in (pidx, jidx))
    _assert_same_find(_per_query(got[0], got[2], got[1]),
                      _per_query(want[0], want[2], want[1]), True)
    assert pidx.timer.count("merge") == 0
    _assert_same_dict(pidx.to_dict(), jidx.to_dict(), True)


@pytest.mark.parametrize("p,hash_name", [(2, "murmur"), (4, "farm"),
                                         (8, "murmur")])
def test_count_index_shards_match_jax(reads, p, hash_name):
    """CountIndex(nparts=p): every key on the shard its owner hash names —
    the shard-by-shard items and per-shard distinct counts equal the JAX
    index's — and the same counts."""
    d, seqs = reads
    path = d / "reads.fastq"
    jidx = japi.CountIndex(kt.KmerSpec(21, kt.DNA), mesh=make_mesh(p),
                           hash_name=hash_name, max_runs=2)
    jidx.insert_batch(jax_read_file(path, kt.DNA), chunk_bases=CHUNK)
    pidx = kp.CountIndex(kp.KmerSpec(21, kp.DNA), device="cpu", nparts=p,
                         hash_name=hash_name, max_runs=2)
    pidx.insert_batch(port_read_file(path, kp.DNA), chunk_bases=CHUNK)
    assert pidx.timer.count("merge") >= 2
    (pw, pc), (jw, jc) = pidx.items(), jidx.items()
    np.testing.assert_array_equal(pw, jw)
    np.testing.assert_array_equal(pc, jc)
    assert pidx.local_sizes() == jidx.local_sizes()
    assert pidx.to_dict() == jidx.to_dict()
    q = _queries(seqs, np.random.default_rng(p), 21, m=400)
    np.testing.assert_array_equal(pidx.count(q), jidx.count(q))
