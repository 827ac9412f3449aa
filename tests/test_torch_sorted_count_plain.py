"""The port's `SortedCountIndex` against the plain PyTorch reference of
kmerind's sort-based count map (``tests/plain_sorted_count.py``),
exactly, on the CPU: `items()` (every distinct key once, in ascending key
order over all shards), `count`, `items_in_range`, `size` and
`local_sizes` (each shard the keys of its splitter range).

The reads come from the benchmark's generator (``kbench/data.py``): half
reverse-complemented, with substitutions and 'N's, written as FASTQ.
They go in through `build` of the file and through `insert_batch` of the
parsed file, both in chunks small enough that many pending chunks wait
for the first query's sort, at k = 31 (two 32-bit key words, one int64
limb of the reference) and k = 45 (three key words, two limbs), on one
shard and on four.  A second file inserted after a query makes the next
sort merge the store's weighted rows with the new chunks.  The
benchmark's frozen reference (``kbench/reference/kmers.py``) gives the
same table at k = 31."""

import pathlib
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import kmerind_tpu_torch as kt  # noqa: E402
from kbench import data  # noqa: E402
from kbench.reference import kmers as frozen  # noqa: E402
from kmerind_tpu_torch.io import read_file  # noqa: E402

import plain_sorted_count as plain  # noqa: E402

#: 101-bp reads of a 3 kbp genome, 2 % N (many reads hold one or more)
READS = {"genome_len": 3_000, "n_reads": 240, "read_len": 101,
         "sub_rate": 0.01, "n_rate": 0.02}
HELD = 16
CHUNK = 1 << 11
KS = [31, 45]
PARTS = [1, 4]
PATHS = ["build", "insert_batch"]


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    """(FASTQ of the first half, FASTQ of the second half, the halves'
    codes, held-out reads' codes)."""
    r = READS
    codes = data.make_reads(r["genome_len"], r["n_reads"] + HELD, 29,
                            r["read_len"], r["sub_rate"], r["n_rate"])
    main, held = codes[:r["n_reads"]], codes[r["n_reads"]:]
    assert (main == 4).any(1).mean() > 0.5
    half = r["n_reads"] // 2
    root = tmp_path_factory.mktemp("sorted_count_plain")
    paths = []
    for i, part in enumerate((main[:half], main[half:])):
        paths.append(root / f"reads{i}.fastq")
        data.write_fastq(part, data.make_quals(part, 29 + i), paths[-1])
    return paths[0], paths[1], main[:half], main[half:], held


def index(k: int, nparts: int):
    idx = kt.SortedCountIndex(kt.KmerSpec(k, kt.DNA), device="cpu",
                              nparts=nparts)
    idx.default_chunk_bases = CHUNK
    return idx


def fill(idx, path, how: str):
    if how == "build":
        idx.build(str(path))
    else:
        idx.insert_batch(read_file(str(path), kt.DNA), chunk_bases=CHUNK)
    return idx


def queries(held, keys, k):
    """Forward limb rows of the held-out reads' windows (mostly present,
    in either orientation), the reverse complements of some table keys,
    and random k-mers (nearly all absent)."""
    rng = np.random.default_rng(k)
    rand = rng.integers(0, 4, (300, k + 1)).astype(np.uint8)
    return torch.cat([plain.windows(held, k, False, "cpu"),
                      plain.windows(rand, k, False, "cpu"),
                      plain.revcomp(keys[:50], k)])


def assert_holds(idx, keys, counts, k, held):
    """Every surface of `idx` against the reference table."""
    got_w, got_c = idx.items()
    assert got_w.dtype == np.uint32 and got_w.shape == (keys.shape[0],
                                                        idx.spec.nwords)
    assert got_c.dtype == np.int64
    np.testing.assert_array_equal(plain.from_words(got_w, k, "cpu").numpy(),
                                  keys.numpy())
    np.testing.assert_array_equal(got_c, counts.numpy())
    assert idx.size() == keys.shape[0]
    spl = plain.from_words(idx.splitter_table(), k, "cpu")
    assert spl.shape[0] == idx.nparts - 1
    assert idx.local_sizes() == plain.shard_sizes(keys, spl, idx.nparts)
    q = queries(held, keys, k)
    want = plain.lookup(keys, counts, plain.canonical(q, k))
    assert (want[-50:] > 0).all() and (want == 0).any()
    np.testing.assert_array_equal(idx.count(plain.to_words(q, k)),
                                  want.numpy())
    lo, hi = keys[keys.shape[0] // 5], keys[keys.shape[0] // 2]
    wk, wc = plain.items_in_range(keys, counts, lo, hi)
    assert 0 < wk.shape[0] < keys.shape[0]
    assert idx.items_in_range(plain.to_int(lo, k), plain.to_int(hi, k)) \
        == [(plain.to_int(r, k), int(c)) for r, c in zip(wk, wc)]


@pytest.mark.parametrize("how", PATHS)
@pytest.mark.parametrize("nparts", PARTS)
@pytest.mark.parametrize("k", KS)
def test_contents_and_queries_equal_the_plain_reference(reads, k, nparts,
                                                        how):
    first, _, codes, _, held = reads
    idx = fill(index(k, nparts), first, how)
    assert idx.timer.count("insert") == len(idx._pending) > 4
    assert idx.splitters is None, "nothing sorts before the first query"
    keys, counts = plain.table(codes, k, "cpu")
    assert (counts > 1).any() and (counts == 1).any()
    assert_holds(idx, keys, counts, k, held)
    assert idx.timer.count("sorted.flush") == 1
    assert "flush" not in idx.timer.durations


@pytest.mark.parametrize("nparts", PARTS)
@pytest.mark.parametrize("k", KS)
def test_an_insert_after_a_query_merges_the_stored_rows(reads, k, nparts):
    """The second sort takes the store's rows, each weighted by its count,
    with the second file's pending chunks and two explicit inserts."""
    first, second, codes0, codes1, held = reads
    idx = fill(index(k, nparts), first, "build")
    t0 = plain.table(codes0, k, "cpu")
    assert idx.size() == t0[0].shape[0]
    fill(idx, second, "insert_batch")
    extra = t0[0][::7]
    idx.insert(plain.to_words(extra, k))
    idx.insert_counts(plain.to_words(extra[:5], k), np.full(5, 3))
    keys, counts = plain.merge(t0, plain.table(codes1, k, "cpu"),
                               (extra, torch.ones(extra.shape[0],
                                                  dtype=torch.int64)),
                               (extra[:5], torch.full((5,), 3)))
    assert keys.shape[0] > t0[0].shape[0]
    assert_holds(idx, keys, counts, k, held)
    assert idx.timer.count("sorted.flush") == 2


def test_items_have_the_count_index_shape_and_contents(reads):
    first, _, codes, _, _ = reads
    s_w, s_c = fill(index(31, 4), first, "build").items()
    c = kt.CountIndex(kt.KmerSpec(31, kt.DNA), device="cpu", nparts=1)
    c_w, c_c = c.build(str(first)).items()
    assert s_w.dtype == c_w.dtype and s_c.dtype == c_c.dtype
    np.testing.assert_array_equal(s_w, c_w)
    np.testing.assert_array_equal(s_c, c_c)


def test_the_reference_equals_the_benchmarks_frozen_copy(reads):
    """At k = 31 one limb is the frozen reference's int64 code, and its
    API words are the benchmark's packing of that code."""
    _, _, codes, _, _ = reads
    keys, counts = plain.table(codes, 31, "cpu")
    fk, fc = frozen.window_table(codes, 31, "cpu")
    np.testing.assert_array_equal(keys[:, 0].numpy(), fk.numpy())
    np.testing.assert_array_equal(counts.numpy(), fc.numpy())
    np.testing.assert_array_equal(plain.to_words(keys, 31),
                                  data.codes_to_words(fk.numpy(), 31))


@pytest.mark.parametrize("k", KS)
def test_words_ints_and_limbs_round_trip(k):
    spec = kt.KmerSpec(k, kt.DNA)
    rng = np.random.default_rng(k)
    limbs = plain.windows(rng.integers(0, 4, (20, k + 3)).astype(np.uint8),
                          k, False, "cpu")
    words = plain.to_words(limbs, k)
    np.testing.assert_array_equal(plain.from_words(words, k, "cpu").numpy(),
                                  limbs.numpy())
    ints = [plain.to_int(r, k) for r in limbs]
    assert ints == spec.to_ints(words).tolist()
    for v, r in zip(ints, limbs):
        assert torch.equal(plain.from_int(v, k), r)
