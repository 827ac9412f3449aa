"""The port's SortedCountIndex against the JAX package's on the same
synthetic reads: the JAX index runs on the conftest's 8-device CPU mesh,
the port's holds as many shards stacked on the CPU.  Chunks are small, so
every index appends several pending runs before its first flush.  Index
contents, splitters, per-shard sizes and every query answer must be equal
(integers: exact equality).

The JAX index is fed one chunk per call, each waited for: its own
multi-chunk `insert_batch` loses k-mers on the CPU backend (a known
reference fault, ROADMAP queue 3)."""

import jax
import numpy as np
import pytest

import kmerind_tpu as kt
import kmerind_tpu_torch as kp
from kmerind_tpu.index.sorted_api import SortedCountIndex as JaxSorted
from kmerind_tpu.io import read_file as jax_read_file
from kmerind_tpu.parallel.mesh import make_mesh
from kmerind_tpu_torch.index.convert import sorted_count_index_from_state
from kmerind_tpu_torch.io import read_file as port_read_file

from torch_parity import write_reads

CHUNK = 5000


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_sorted") / "reads.fastq"
    seqs = write_reads(path, 250, 120, 2000, seed=21, n_rate=0.005)
    return path, seqs


def _jax_index(path, p, canonical=True, k=21, **kw):
    jidx = JaxSorted(kt.KmerSpec(k, kt.DNA), mesh=make_mesh(p),
                     canonical=canonical, **kw)
    for chunk in jax_read_file(path, kt.DNA).iter_chunks(CHUNK, k - 1):
        jidx.insert_batch(chunk)
        jax.block_until_ready(jidx._pending[-1])
    return jidx


def _pair(path, p, canonical=True, k=21, **kw):
    pidx = kp.SortedCountIndex(kp.KmerSpec(k, kp.DNA), device="cpu",
                               canonical=canonical, nparts=p, **kw)
    pidx.insert_batch(port_read_file(path, kp.DNA), chunk_bases=CHUNK)
    return _jax_index(path, p, canonical, k, **kw), pidx


def _queries(seqs, rng, k=21, m=400):
    out = []
    for _ in range(m // 2):
        r = seqs[int(rng.integers(len(seqs)))]
        i = int(rng.integers(len(r) - k + 1))
        out.append(r[i:i + k].replace("N", "A"))
    return out + ["".join(rng.choice(list("ACGT"), k)) for _ in range(m // 2)]


def _assert_same_layout(jidx, pidx):
    assert pidx.to_dict() == jidx.to_dict()
    np.testing.assert_array_equal(pidx.splitter_table(),
                                  jidx.splitter_table())
    np.testing.assert_array_equal(pidx.store.size.numpy(),
                                  np.asarray(jidx.store.size))


@pytest.mark.parametrize("p,canonical", [(1, True), (4, True), (8, True),
                                         (1, False), (4, False), (8, False)])
def test_sorted_count_index_matches_jax(reads, p, canonical):
    path, seqs = reads
    jidx, pidx = _pair(path, p, canonical)
    assert len(pidx._pending) == pidx.timer.count("insert") >= 6
    _assert_same_layout(jidx, pidx)
    assert pidx.size() == jidx.size() == len(jidx.to_dict())

    rng = np.random.default_rng(p)
    q = _queries(seqs, rng)
    np.testing.assert_array_equal(pidx.count(q), jidx.count(q))
    (pw, pc), (jw, jc) = pidx.find(q), jidx.find(q)
    np.testing.assert_array_equal(pw, jw)
    np.testing.assert_array_equal(pc, jc)

    keys = sorted(jidx.to_dict())
    lo, hi = keys[len(keys) // 5], keys[len(keys) // 2]
    got = pidx.items_in_range(lo, hi)
    assert got == jidx.items_in_range(lo, hi)
    assert len(got) == len(keys) // 2 - len(keys) // 5

    assert pidx.erase(q[:150]) == jidx.erase(q[:150]) > 0
    assert pidx.size() == jidx.size()
    np.testing.assert_array_equal(pidx.count(q), jidx.count(q))

    # a second flush re-sorts the store's rows with new pending rows
    more = q[100:300]
    pidx.insert(more)
    jidx.insert(more)
    pidx.insert_counts(more[:50], np.arange(50))
    jidx.insert_counts(more[:50], np.arange(50))
    _assert_same_layout(jidx, pidx)


def test_incremental_inserts_resort():
    """test_sorted_index.py::test_sorted_count_incremental_inserts_resort,
    on the port."""
    spec = kp.KmerSpec(15, kp.DNA)
    idx = kp.SortedCountIndex(spec, device="cpu", nparts=4, canonical=False)
    idx.insert(["A" * 15, "C" * 15, "A" * 15])
    assert idx.count(["A" * 15, "C" * 15, "G" * 15]).tolist() == [2, 1, 0]
    idx.insert(["G" * 15, "A" * 15])
    assert idx.count(["A" * 15, "C" * 15, "G" * 15]).tolist() == [3, 1, 1]
    assert idx.size() == 3
    # weighted inserts
    idx.insert_counts(["T" * 14 + "A"], [7])
    assert idx.count(["T" * 14 + "A"]).tolist() == [7]


def test_saturate_and_full_word_keys(reads):
    """k=16 fills the key word (no sentinel-safe keys: flag-mode sorts);
    counts clip at `saturate` on every flush, as in the JAX index."""
    path, seqs = reads
    jidx, pidx = _pair(path, 4, k=16, saturate=3)
    _assert_same_layout(jidx, pidx)
    assert max(pidx.to_dict().values()) == 3
    q = _queries(seqs, np.random.default_rng(3), k=16)
    np.testing.assert_array_equal(pidx.count(q), jidx.count(q))


def test_save_load_across_packages(reads, tmp_path):
    """A JAX save loads in the port and a port save in the JAX package,
    at another shard count."""
    path, _ = reads
    jidx, pidx = _pair(path, 4)
    jidx.save(tmp_path / "jax.npz")
    pidx.save(tmp_path / "port.npz")
    want = jidx.to_dict()
    from_jax = kp.SortedCountIndex.load(tmp_path / "jax.npz", "cpu", nparts=2)
    assert from_jax.to_dict() == want and from_jax.nparts == 2
    from_port = JaxSorted.load(tmp_path / "port.npz", mesh=make_mesh(8))
    assert from_port.to_dict() == want


def test_convert_jax_state(reads):
    """A JAX index's store and splitters carried across answer 1,000
    queries the same, without a flush."""
    path, seqs = reads
    jidx = _jax_index(path, 4)
    jidx._flush()
    s = jidx.store
    pidx = sorted_count_index_from_state(
        np.asarray(s.keys), np.asarray(s.counts), np.asarray(s.size),
        np.asarray(jidx.splitters), kp.KmerSpec(21, kp.DNA), "cpu")
    q = _queries(seqs, np.random.default_rng(7), m=1000)
    np.testing.assert_array_equal(pidx.count(q), jidx.count(q))
    assert pidx.timer.count("flush") == 0
    assert pidx.to_dict() == jidx.to_dict()


def test_not_ported_surfaces_raise():
    """Every family IndexConfig names builds in the port, in both
    distributions; only the combinations the JAX package refuses raise its
    ValueError (the Bimolecule preset with the range distribution or a
    non-count index).  The other two strand transforms are ported: the
    sorted index takes them."""
    for cfg, cls in (({"strands": "bimolecule"}, kp.BimoleculeCountIndex),
                     ({"index": "value"}, kp.KmerValueIndex),
                     ({"index": "value", "distribution": "range"},
                      kp.SortedKmerValueIndex)):
        assert type(kp.IndexConfig(**cfg).make_index("cpu")) is cls
    for cfg in ({"strands": "bimolecule", "distribution": "range"},
                {"strands": "bimolecule", "index": "position"}):
        with pytest.raises(ValueError, match="Bimolecule"):
            kp.IndexConfig(**cfg).make_index("cpu")
    for transform in ("lex_greater", "xor_rev_comp"):
        idx = kp.IndexConfig(strands=transform,
                             distribution="range").make_index("cpu")
        assert type(idx) is kp.SortedCountIndex
        assert idx.transform == transform
