"""The port's `BimoleculeCountIndex` against the plain PyTorch reference of
kmerind's Bimolecule map (``tests/plain_bimolecule.py``), exactly, on the
CPU: counts, found sets and each key's stored orientation (its earliest
occurrence's).

The reads come from the benchmark's generator (``kbench/data.py``): half
reverse-complemented, with substitutions and 'N's, written as FASTQ and
built through the public API, whole, in chunks small enough that many
chunks and flushes are crossed, and streamed in byte blocks.  Also:
explicit inserts after the file rank after every file occurrence, the
benchmark's frozen copy of the reference (``kbench/reference/
bimolecule.py``) gives the same answers, and the spans "bimol.flush" and
"bimol.strands" are entered as named."""

import pathlib
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import kmerind_tpu_torch as kt  # noqa: E402
from kbench import data  # noqa: E402
from kbench.reference import bimolecule as frozen  # noqa: E402

import plain_bimolecule as plain  # noqa: E402

K = 31
#: 101-bp reads of a 3 kbp genome, 2 % N (many reads hold one or more)
READS = {"genome_len": 3_000, "n_reads": 240, "read_len": 101,
         "sub_rate": 0.01, "n_rate": 0.02}
HELD = 16
#: (default_chunk_bases, flush_rows, block_bytes of a streamed build)
BUILDS = {"whole": (None, None, None),
          "chunked": (1 << 11, 3_000, None),
          "streamed": (1 << 11, 5_000, 1 << 13)}


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    """(FASTQ path, the reads' codes, held-out reads' codes)."""
    r = READS
    codes = data.make_reads(r["genome_len"], r["n_reads"] + HELD, 23,
                            r["read_len"], r["sub_rate"], r["n_rate"])
    main, held = codes[:r["n_reads"]], codes[r["n_reads"]:]
    assert (main == 4).any(1).mean() > 0.5
    path = tmp_path_factory.mktemp("bimolecule_plain") / "reads.fastq"
    data.write_fastq(main, data.make_quals(main, 23), path)
    return path, main, held


@pytest.fixture(scope="module")
def ref(reads):
    """The reference table of the reads: (keys, counts, first strands)."""
    return plain.table(reads[1], K, "cpu")


def built(path, build):
    chunk, flush, block = BUILDS[build]
    idx = kt.BimoleculeCountIndex(kt.KmerSpec(K, kt.DNA), device="cpu",
                                  nparts=1)
    if chunk is not None:
        idx.default_chunk_bases = chunk
    if flush is not None:
        idx.flush_rows = flush
    if block is not None:
        return idx.build_stream(str(path), block_bytes=block)
    return idx.build(str(path))


def queries(held, ref, n_random=300):
    """int64 query codes in input orientation: the held-out reads'
    forward windows (mostly found), the reverse complements of some held
    keys, and random k-mers (nearly all absent)."""
    fwd, _ = plain._windows(torch.from_numpy(held), K)
    rng = np.random.default_rng(7)
    absent = torch.from_numpy(rng.integers(0, 1 << (2 * K), n_random))
    return torch.cat([fwd.reshape(-1), plain.revcomp(ref[0][:50], K),
                      absent])


def words(codes: torch.Tensor) -> np.ndarray:
    return data.codes_to_words(codes.numpy(), K)


@pytest.mark.parametrize("build", list(BUILDS))
def test_find_items_and_count_equal_the_plain_reference(reads, ref, build):
    path, _, held = reads
    keys, counts, strand = ref
    idx = built(path, build)
    if build != "whole":
        assert idx.timer.count("bimol.flush") > 2, "several flushes"
    q = queries(held, ref)
    got_w, got_c = idx.find(words(q))
    want_w, want_c = plain.find(keys, counts, strand, q, K)
    assert 0 < want_c.numel() < q.numel()
    np.testing.assert_array_equal(data.words_to_codes(got_w, K),
                                  want_w.numpy())
    np.testing.assert_array_equal(got_c, want_c.numpy())
    cq = plain.canonical(q, K)
    pos = torch.searchsorted(keys, cq).clamp_(max=keys.numel() - 1)
    want_n = torch.where(keys[pos] == cq, counts[pos], 0)
    np.testing.assert_array_equal(idx.count(words(q)), want_n.numpy())
    got_w, got_c = idx.items()
    want_w, want_c = plain.items(keys, counts, strand, K)
    np.testing.assert_array_equal(data.words_to_codes(got_w, K),
                                  want_w.numpy())
    np.testing.assert_array_equal(got_c, want_c.numpy())
    assert idx.size() == keys.numel()


def test_first_occurrences_take_both_strands(reads, ref):
    """Half the reads are reverse-complemented: many keys are stored in
    their reverse orientation, and many keys were seen on both strands,
    so the earliest occurrence decides (the last-occurrence table
    differs)."""
    _, main, _ = reads
    keys, counts, strand = ref
    assert 0.3 < strand.double().mean() < 0.7
    _, _, last = plain.table(main, K, "cpu", last=True)
    flipped = int((last != strand).sum())
    assert 0 < flipped < keys.numel()
    assert bool((counts[last != strand] > 1).all())


def test_inserts_after_the_file_rank_after_every_file_id(reads, ref):
    """Explicit inserts after the build: a key the file holds keeps its
    file orientation (its count grows); a new key takes the orientation
    of its first insert, a later insert of it on the other strand does
    not change it."""
    path, _, _ = reads
    keys = ref[0]
    have = plain.revcomp(keys[:40], K)          # held keys, other strand
    rng = np.random.default_rng(11)
    new = torch.from_numpy(rng.integers(0, 1 << (2 * K), 60))
    assert not bool(torch.isin(plain.canonical(new, K), keys).any())
    ins = torch.cat([have, new, plain.revcomp(new[:20], K), new[:10]])
    idx = built(path, "chunked")
    idx.insert(words(ins))
    got_w, got_c = idx.items()
    t = plain.table(reads[1], K, "cpu", inserted=ins.numpy())
    want_w, want_c = plain.items(*t, K)
    np.testing.assert_array_equal(data.words_to_codes(got_w, K),
                                  want_w.numpy())
    np.testing.assert_array_equal(got_c, want_c.numpy())
    # the new keys are stored as first inserted, not as re-inserted
    f_w, f_c = idx.find(words(new))
    np.testing.assert_array_equal(data.words_to_codes(f_w, K), new.numpy())
    np.testing.assert_array_equal(f_c, [3] * 10 + [2] * 10 + [1] * 40)


def test_frozen_copy_gives_the_same_answers(reads, ref):
    _, main, held = reads
    q = queries(held, ref)
    ins = plain.revcomp(ref[0][:25], K).numpy()
    for kw in ({}, {"last": True}, {"inserted": ins}):
        a = plain.table(main, K, "cpu", **kw)
        b = frozen.table(main, K, "cpu", **kw)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        for x, y in zip(plain.find(*a, q, K), frozen.find(*b, q, K)):
            assert torch.equal(x, y)
        for x, y in zip(plain.items(*a, K), frozen.items(*b, K)):
            assert torch.equal(x, y)
    for x, y in zip(plain.windows(held, K, "cpu"),
                    frozen.windows(held, K, "cpu")):
        assert torch.equal(x, y)


def test_the_reference_refuses_an_even_k(reads):
    with pytest.raises(ValueError):
        plain.table(reads[1], 30, "cpu")


def test_flush_and_strand_spans(reads):
    """"bimol.flush" is entered once per flush with rows pending, never on
    an empty one; "bimol.strands" once per store version, then cached."""
    path, _, held = reads
    idx = built(path, "chunked")
    q = words(queries(held, plain.table(reads[1], K, "cpu")))
    t = idx.timer
    assert t.count("bimol.flush") > 2 and t.count("bimol.strands") == 0
    idx.insert(q[:5])                   # flushes the build, then pends
    n = t.count("bimol.flush")
    idx.find(q)
    assert t.count("bimol.flush") == n + 1
    assert t.count("bimol.strands") == 1
    idx.find(q)
    idx.count(q)
    assert t.count("bimol.flush") == n + 1
    assert t.count("bimol.strands") == 1
    idx.insert(q[:5])
    assert t.count("bimol.flush") == n + 1
    idx.find(q)
    assert t.count("bimol.flush") == n + 2
    assert t.count("bimol.strands") == 2


def test_a_compaction_makes_its_minimum_in_its_own_span(reads, ref):
    """Every compaction step enters "bimol.min_rep" once, inside
    "compact"; the representatives it makes there are those the
    compaction would make itself, and the compacted map still answers as
    the reference."""
    path, _, held = reads
    keys, counts, strand = ref
    idx = built(path, "chunked")
    store = idx.runs[0].shard(0)
    cap = store.capacity
    made = kt.index.store.run_bimol_compact(store, cap)[0]
    given = kt.index.store.run_bimol_compact(
        store, cap, reps=kt.index.store.run_bimol_min_rep(store))[0]
    for f in ("keys", "weights", "csum", "rep_hi", "rep_lo", "rep_strand"):
        torch.testing.assert_close(getattr(given, f), getattr(made, f),
                                   rtol=0, atol=0, msg=f)
    t = idx.timer
    before = t.count("bimol.min_rep")
    assert before == t.count("compact")
    idx.compact(16)                     # too small: cut, then retried larger
    assert t.count("bimol.min_rep") - before == t.count("compact") - before \
        >= 2
    q = queries(held, ref)
    got_w, got_c = idx.find(words(q))
    want_w, want_c = plain.find(keys, counts, strand, q, K)
    np.testing.assert_array_equal(data.words_to_codes(got_w, K),
                                  want_w.numpy())
    np.testing.assert_array_equal(got_c, want_c.numpy())
