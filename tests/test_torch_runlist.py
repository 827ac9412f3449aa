"""The LSM run list that the count indexes and the de Bruijn graphs share
(`index.api._RunListIndex`), over `CountIndex`, `BimoleculeCountIndex`,
`DeBruijnGraph` and `QualityDeBruijnGraph` at 1 and 4 shards on the CPU:

- the run-list shapes that a fixed sequence of chunked builds, an adopt,
  a reserve, a checkpoint round trip and a compaction leaves — the runs'
  capacities, the `_unit` flags and the weight bound `_ingested_weight` —
  equal the values recorded from the two families' own run lists before
  the policy was shared (`SHAPES`);
- the query aux cache holds only runs still in the run list after merges;
- each family's int32 weight guard raises its own `OverflowError`."""

import numpy as np
import pytest

import kmerind_tpu_torch as kp
from kmerind_tpu_torch.io import read_file
from kmerind_tpu_torch.utils.checkpoint import load_index, save_index

from torch_parity import write_reads

CLASSES = {"count": kp.CountIndex, "bimolecule": kp.BimoleculeCountIndex,
           "debruijn": kp.DeBruijnGraph,
           "quality_debruijn": kp.QualityDeBruijnGraph}
CHUNK = 8000
#: each family's OverflowError text, from its first words
OVERFLOW = {"count": "count index raw weight",
            "bimolecule": "Bimolecule raw weight",
            "debruijn": "de Bruijn raw weight",
            "quality_debruijn": "de Bruijn raw weight"}


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    """(FASTQ path of a 1.2 kb genome at ~12x with varied qualities, query
    k-mers: windows of its first reads)."""
    path = tmp_path_factory.mktemp("torch_runlist") / "reads.fastq"
    seqs = write_reads(path, 120, 120, 1200, seed=23, n_rate=0.002,
                       varied_quality=True)
    return path, [r[i:i + 21].replace("N", "A") for r in seqs[:20]
                  for i in range(0, 100, 7)]


def _new(name, p):
    cls = CLASSES[name]
    kw = {} if cls is kp.BimoleculeCountIndex else {"max_runs": 2}
    return cls(kp.KmerSpec(21, kp.DNA), device="cpu", nparts=p, **kw)


def _build(idx, path):
    return idx.insert_batch(read_file(path, idx.parse_alphabet),
                            chunk_bases=CHUNK)


def _query(idx, kmers) -> np.ndarray:
    """The counts (a graph's counters) of `kmers`; the query caches each
    run's aux, and a Bimolecule index first merges its pending runs."""
    if isinstance(idx, kp.DeBruijnGraph):
        return idx.node_counts(kmers)[0]
    return idx.count(kmers)


def _shape(idx) -> tuple:
    return ([r.capacity for r in idx.runs], list(idx._unit),
            idx._ingested_weight)


def run_list_shapes(name, p, reads, tmp) -> dict:
    """{step: (run capacities, _unit, _ingested_weight)} after each step of
    one fixed sequence on a `name` index of `p` shards."""
    path, kmers = reads
    out = {}
    idx = _build(_new(name, p), path)
    _query(idx, kmers)
    out["build"] = _shape(idx)
    _query(_build(idx, path), kmers)
    out["rebuild"] = _shape(idx)
    fresh = _new(name, p).adopt_runs(list(idx.runs) * 2)
    out["adopt"] = _shape(fresh)
    fresh.reserve(2 * p * fresh.capacity)
    out["reserve"] = _shape(fresh)
    save_index(fresh, tmp / "ck")
    out["saved"] = _shape(fresh)
    back = load_index(tmp / "ck", "cpu")
    out["loaded"] = _shape(back)
    back.compact()
    out["compact"] = _shape(back)
    return out


#: `run_list_shapes` as the two families' own run lists gave it, before
#: `_RunListIndex` held the policy for both
SHAPES = {
    ("count", 1): {
        "build": ([8020, 8020], [True, True], 16040),
        "rebuild": ([16384, 16384], [True, True], 32080),
        "adopt": ([32768, 32768], [False, False], 48000),
        "reserve": ([32768, 98304], [False, False], 48000),
        "saved": ([4096], [False], 48000),
        "loaded": ([4096], [False], 48000),
        "compact": ([4096], [False], 48000),
    },
    ("count", 4): {
        "build": ([4096, 4096], [True, True], 8192),
        "rebuild": ([8192, 8192], [True, True], 16384),
        "adopt": ([16384, 16384], [False, False], 13212),
        "reserve": ([16384, 49152], [False, False], 13212),
        "saved": ([4096], [False], 13212),
        "loaded": ([4096], [False], 13212),
        "compact": ([1024], [False], 13212),
    },
    ("bimolecule", 1): {
        "build": ([16384], [False], 16040),
        "rebuild": ([4096], [False], 32080),
        "adopt": ([8192], [False], 48000),
        "reserve": ([16384], [False], 48000),
        "saved": ([16384], [False], 48000),
        "loaded": ([16384], [False], 48000),
        "compact": ([4096], [False], 48000),
    },
    ("bimolecule", 4): {
        "build": ([8192], [False], 8192),
        "rebuild": ([16384], [False], 16384),
        "adopt": ([32768], [False], 13212),
        "reserve": ([65536], [False], 13212),
        "saved": ([65536], [False], 13212),
        "loaded": ([65536], [False], 13212),
        "compact": ([1024], [False], 13212),
    },
    ("debruijn", 1): {
        "build": ([8022, 8022], [True, True], 16044),
        "rebuild": ([16384, 16384], [True, True], 32088),
        "adopt": ([32768, 32768], [False, False], 48000),
        "reserve": ([32768, 98304], [False, False], 48000),
        "saved": ([8192], [False], 48000),
        "loaded": ([8192], [False], 48000),
        "compact": ([8192], [False], 48000),
    },
    ("debruijn", 4): {
        "build": ([4096, 4096], [True, True], 16224),
        "rebuild": ([8192, 8192], [True, True], 32448),
        "adopt": ([16384, 16384], [False, False], 13212),
        "reserve": ([16384, 49152], [False, False], 13212),
        "saved": ([4096], [False], 13212),
        "loaded": ([4096], [False], 13212),
        "compact": ([4096], [False], 13212),
    },
    ("quality_debruijn", 1): {
        "build": ([8022, 8022], [True, True], 16044),
        "rebuild": ([16384, 16384], [True, True], 32088),
        "adopt": ([32768, 32768], [False, False], 48000),
        "reserve": ([32768, 98304], [False, False], 48000),
        "saved": ([8192], [False], 48000),
        "loaded": ([8192], [False], 48000),
        "compact": ([8192], [False], 48000),
    },
    ("quality_debruijn", 4): {
        "build": ([4096, 4096], [True, True], 16224),
        "rebuild": ([8192, 8192], [True, True], 32448),
        "adopt": ([16384, 16384], [False, False], 13212),
        "reserve": ([16384, 49152], [False, False], 13212),
        "saved": ([4096], [False], 13212),
        "loaded": ([4096], [False], 13212),
        "compact": ([4096], [False], 13212),
    },
}


@pytest.mark.parametrize("p", [1, 4])
@pytest.mark.parametrize("name", list(CLASSES))
def test_run_list_shapes_are_pinned(reads, tmp_path, name, p):
    got = run_list_shapes(name, p, reads, tmp_path)
    assert got == SHAPES[name, p]


@pytest.mark.parametrize("p", [1, 4])
@pytest.mark.parametrize("name", list(CLASSES))
def test_aux_cache_holds_only_live_runs(reads, name, p):
    """A query caches each run's aux; the merges of a second build (a
    Bimolecule index's at its flush) then replace runs, and no cache entry
    keeps a run that left the list.  The answers after that equal a fresh
    index's over the same two builds."""
    path, kmers = reads
    idx = _build(_new(name, p), path)
    _query(idx, kmers)
    before = list(idx.runs)
    assert len(idx._aux_cache) == len(before)
    assert all(r is x for (r, _), x in zip(idx._aux_cache, before))
    _build(idx, path)
    if name == "bimolecule":
        idx._flush()
    assert any(all(r is not x for x in idx.runs) for r in before)
    for r, _ in idx._aux_cache:
        assert any(r is x for x in idx.runs)
    got = _query(idx, kmers)
    assert len(idx._aux_cache) == len(idx.runs)
    assert all(r is x for (r, _), x in zip(idx._aux_cache, idx.runs))
    idx._consolidate()
    assert all(r is idx.runs[0] for r, _ in idx._aux_cache)
    want = _query(_build(_build(_new(name, p), path), path), kmers)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("p", [1, 4])
@pytest.mark.parametrize("name", list(CLASSES))
def test_weight_guard_raises(name, p):
    """Past the guard, the bound is tightened to the true worst shard
    total; when that plus the incoming weight would pass 2^31 - 1, the
    family's own OverflowError is raised and the bound keeps the total."""
    idx = _new(name, p)
    idx._ingested_weight = idx._I32_WEIGHT_GUARD - 1
    idx._shard_weight = lambda: (1 << 31) - 10
    with pytest.raises(OverflowError, match=OVERFLOW[name]):
        idx._note_weight(100)
    assert idx._ingested_weight == (1 << 31) - 10
    idx._shard_weight = lambda: 5
    idx._note_weight(100)
    assert idx._ingested_weight == 105
