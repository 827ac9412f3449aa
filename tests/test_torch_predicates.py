"""The predicate surface — erase_if, filter, count_if, find_if — of every
index family the port has, against the JAX package on the same synthetic
reads: CountIndex and SortedCountIndex (predicates over (keys, counts)),
and the multimaps — the hash family with quality, the range family
without (the other two classes share their code) — with predicates over
(keys, id_hi, id_lo, qual) pairs and query predicates over (keys,
counts).  Each lambda is written with operators both jnp and torch
accept; the port hands it int64 key words and id halves holding the
unsigned values, so the top key bit ((k[:, 0] >> 31) == 1 in both
packages; k[:, 0] >= 0x80000000 in the port, where jnp's uint32 refuses
the literal) selects the same keys.  The JAX indexes run on the conftest's
8-device CPU mesh, each scenario once (cached for both shard counts); the
port's hold 1 or 4 shards on the CPU.  Counts, keys and ids: exact;
qualities: rtol 1e-5."""

import functools

import jax
import numpy as np
import pytest

import kmerind_tpu as kt
import kmerind_tpu_torch as kp
from kmerind_tpu.index import api as japi
from kmerind_tpu.index import sorted_api as jsapi
from kmerind_tpu.io import read_file as jax_read_file
from kmerind_tpu.parallel.mesh import make_mesh
from kmerind_tpu_torch.io import read_file as port_read_file

from torch_parity import write_reads

CHUNK = 3000
TOP = 0x80000000


def top_bit(k):
    """The top bit of key word 0, in operators jnp and torch share."""
    return (k[:, 0] >> 31) == 1


FAMILIES = {
    "count": (japi.CountIndex, kp.CountIndex),
    "sorted_count": (jsapi.SortedCountIndex, kp.SortedCountIndex),
    "hash_q": (japi.PositionQualityIndex, kp.PositionQualityIndex),
    "sorted": (jsapi.SortedPositionIndex, kp.SortedPositionIndex),
}


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    """A 1.5 kb genome at ~8x with varied qualities: keys repeat, counts
    spread over 1..~20."""
    path = tmp_path_factory.mktemp("torch_predicates") / "reads.fastq"
    seqs = write_reads(path, 120, 100, 1500, seed=31, n_rate=0.005,
                       varied_quality=True)
    return path, tuple(seqs)


def _queries(seqs, seed, k=21, m=160):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(m // 2):
        r = seqs[int(rng.integers(len(seqs)))]
        i = int(rng.integers(len(r) - k + 1))
        out.append(r[i:i + k].replace("N", "A"))
    return out + ["".join(rng.choice(list("ACGT"), k)) for _ in range(m // 2)]


def _jax_index(family, path):
    jcls = FAMILIES[family][0]
    kw = {} if family.endswith("count") else {"canonical": True}
    idx = jcls(kt.KmerSpec(21, kt.DNA), mesh=make_mesh(8), **kw)
    for chunk in jax_read_file(path, kt.DNA).iter_chunks(CHUNK, 20):
        idx.insert_batch(chunk)
        if hasattr(idx, "_pending") and idx._pending:
            jax.block_until_ready(idx._pending[-1])
    return idx


def _port_index(family, path, p):
    pcls = FAMILIES[family][1]
    kw = {} if family.endswith("count") else {"canonical": True}
    idx = pcls(kp.KmerSpec(21, kp.DNA), device="cpu", nparts=p, **kw)
    return idx.insert_batch(port_read_file(path, kp.DNA), chunk_bases=CHUNK)


# ------------------------------------------------------------ count indexes
def _count_script(idx, q):
    """The same calls on either package's count index: (name, answer)."""
    out = [("count_if c>=5", sorted(idx.count_if(lambda k, c: c >= 5))),
           ("count_if top bit", sorted(idx.count_if(
               lambda k, c: top_bit(k)))),
           ("count_if kmers", idx.count_if(lambda k, c: c % 2 == 1, q)),
           ("find_if kmers", idx.find_if(lambda k, c: c > 3, q)),
           ("find_if", sorted(idx.find_if(lambda k, c: c == 2)))]
    out.append(("erase_if kmers", idx.erase_if(lambda k, c: c > 6, q)))
    out.append(("after erase_if kmers", idx.to_dict()))
    out.append(("filter c>=2", idx.filter(lambda k, c: c >= 2)))
    out.append(("spectrum", idx.histogram(10)))
    out.append(("erase_if top bit", idx.erase_if(
        lambda k, c: top_bit(k))))
    out.append(("contents", idx.to_dict()))
    return out


@functools.lru_cache
def _jax_count(family, path, seqs):
    return _count_script(_jax_index(family, path), _queries(seqs, 2))


@pytest.mark.parametrize("family,p", [("count", 1), ("count", 4),
                                      ("sorted_count", 1),
                                      ("sorted_count", 4)])
def test_count_predicates_match_jax(reads, family, p):
    path, seqs = reads
    want = _jax_count(family, path, seqs)
    pidx = _port_index(family, path, p)
    # the port's int64 words compare unsigned
    assert sorted(pidx.count_if(lambda k, c: k[:, 0] >= TOP)) == dict(
        want)["count_if top bit"] != []
    got = _count_script(pidx, _queries(seqs, 2))
    for (name, g), (_, w) in zip(got, want):
        if isinstance(w, tuple):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b, err_msg=name)
        elif isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            assert g == w, name
    top = dict(want)
    assert top["filter c>=2"] > 0 and top["spectrum"][1] == 0
    assert top["erase_if top bit"] > 0
    assert all(pidx.spec.from_int(v)[0] < TOP for v in top["contents"])


# -------------------------------------------------------------- multimaps
def _multi_script(idx, q):
    """The same calls on either package's multimap: (name, answer).
    Pair predicates pick ids by their low bit and, with quality, windows by
    quality."""
    wq = idx.with_quality

    def pair(k, h, l, qu):
        return ((l & 1) == 0) & (qu < 0.95) if wq else (l & 3) == 0

    out = [("count_if pairs", idx.count_if(pair)),
           ("count_if top bit", idx.count_if(
               lambda k, h, l, qu: top_bit(k))),
           ("count_if kmers", idx.count_if(lambda k, c: c >= 3, q))]
    ids, mask = idx.find_if(lambda k, c: c >= 3, q, max_per_query=4)
    out.append(("find_if kmers", [sorted(ids[i][mask[i]].tolist())
                                  for i in range(len(q))]))
    out.append(("erase_if kmers", idx.erase_if(pair, q[:60])))
    out.append(("after erase_if kmers", idx.size()))
    out.append(("filter", idx.filter(
        lambda k, h, l, qu: (h >= 0) & ((l & 7) != 5))))
    out.append(("erase_if top bit", idx.erase_if(
        lambda k, h, l, qu: top_bit(k))))
    out.append(("contents", idx.to_dict()))
    return out


@functools.lru_cache
def _jax_multi(family, path, seqs):
    return _multi_script(_jax_index(family, path), _queries(seqs, 3))


def _same_contents(got, want, with_quality):
    assert got.keys() == want.keys()
    for key, pairs in want.items():
        if not with_quality:
            assert got[key] == pairs
            continue
        assert [i for i, _ in got[key]] == [i for i, _ in pairs]
        g = np.array([x for _, x in got[key]], np.float32)
        w = np.array([x for _, x in pairs], np.float32)
        np.testing.assert_array_equal(g == 0, w == 0)
        np.testing.assert_allclose(g, w, rtol=1e-5)


@pytest.mark.parametrize("family,p", [("hash_q", 4), ("sorted", 1)])
def test_multimap_predicates_match_jax(reads, family, p):
    path, seqs = reads
    want = _jax_multi(family, path, seqs)
    pidx = _port_index(family, path, p)
    got = _multi_script(pidx, _queries(seqs, 3))
    for (name, g), (_, w) in zip(got, want):
        if name == "contents":
            _same_contents(g, w, pidx.with_quality)
        elif isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            assert g == w, name
    answers = dict(want)
    assert answers["erase_if kmers"] > 0 and answers["filter"] > 0
    assert answers["erase_if top bit"] > 0
    assert all(pidx.spec.from_int(v)[0] < TOP for v in answers["contents"])
