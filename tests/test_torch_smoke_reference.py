"""chip_smoke.py P7's numpy reference at a small size: canonical k-mer
limbs of every window (rolled one base at a time) against the port's
canonical words, the k=127 query packing against KmerSpec.pack_codes, and
the hash-sorted multiset's counts against collections.Counter."""

import collections
import pathlib
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from kmerind_tpu_torch import DNA, KmerSpec  # noqa: E402
from kmerind_tpu_torch.ops import packing  # noqa: E402

from torch_parity import words_np  # noqa: E402


@pytest.mark.parametrize("k", [97, 127, 128])
def test_canonical_limbs_match_the_port(k):
    """Every window of 30 reads, N read as A: the limbs' number equals the
    port's canonical words' number (KmerSpec.to_ints)."""
    codes = chip_smoke.make_reads(3000, 30, seed=k)
    limbs = chip_smoke.canonical_limbs(codes, k)
    spec = KmerSpec(k, DNA)
    nwin = codes.shape[1] - k + 1
    clean = np.where(codes == 4, 0, codes).astype(np.uint8)
    want = []
    for read in clean:
        words, _ = packing.extract_canonical(torch.from_numpy(read), spec)
        want += spec.to_ints(words_np(words)[:nwin]).tolist()
    got = [(int(a) << 192) | (int(b) << 128) | (int(c) << 64) | int(d)
           for a, b, c, d in limbs]
    assert got == want


def test_pack_rows_is_the_kmer_layout():
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 4, (20, 127)).astype(np.uint8)
    spec = KmerSpec(127, DNA)
    np.testing.assert_array_equal(
        chip_smoke.pack_rows(codes),
        np.stack([spec.pack_codes(c) for c in codes]))


def test_limb_counter_counts_exactly():
    rng = np.random.default_rng(4)
    rows = rng.integers(0, 2**62, (50, 4), dtype=np.uint64)
    limbs = rows[rng.integers(0, 50, 3000)]
    ref = chip_smoke.LimbCounter(limbs)
    want = collections.Counter(map(tuple, limbs.tolist()))
    q = np.concatenate([rows, rng.integers(0, 2**62, (10, 4),
                                           dtype=np.uint64)])
    first, cnt = ref.span(q)
    assert cnt.tolist() == [want[tuple(r)] for r in q.tolist()]
    for f, c, r in zip(first, cnt, q):
        got = limbs[ref.order[f:f + c]]
        assert (got == r).all()


def test_p8_spectrum_and_counts_model():
    """P8's numpy model: distinct_counts and spectrum of sorted codes
    against collections.Counter, add_counts against a summed Counter."""
    rng = np.random.default_rng(8)
    codes = np.sort(rng.integers(0, 300, 5000).astype(np.uint64))
    counter = collections.Counter(codes.tolist())
    keys, cnts = chip_smoke.distinct_counts(codes)
    assert dict(zip(keys.tolist(), cnts.tolist())) == counter
    assert keys.tolist() == sorted(counter)
    want = np.zeros(31, np.int64)
    for c in counter.values():
        want[min(c, 30)] += 1
    np.testing.assert_array_equal(chip_smoke.spectrum(cnts, 30), want)
    add_keys = rng.integers(200, 400, 700).astype(np.uint64)
    add_cnts = rng.integers(1, 1001, 700)
    total = collections.Counter(counter)
    for k, c in zip(add_keys.tolist(), add_cnts.tolist()):
        total[k] += c
    keys2, cnts2 = chip_smoke.add_counts(keys, cnts, add_keys, add_cnts)
    assert keys2.tolist() == sorted(total)
    assert dict(zip(keys2.tolist(), cnts2.tolist())) == total


def test_code_rows_is_the_kmer_layout():
    """P8's 2-bit code -> word rows: the rows pack_rows gives the codes'
    bases, and the code is the port's to_ints value."""
    rng = np.random.default_rng(9)
    codes = rng.integers(0, 4, (50, 21)).astype(np.uint8)
    value = np.zeros(50, np.uint64)
    for j in range(21):
        value = (value << np.uint64(2)) | codes[:, j].astype(np.uint64)
    rows = chip_smoke.code_rows(value)
    np.testing.assert_array_equal(rows, chip_smoke.pack_rows(codes))
    np.testing.assert_array_equal(KmerSpec(21, DNA).to_ints(rows), value)


def test_p9_graph_model_matches_the_oracle():
    """P9's numpy model (graph_windows -> graph_nodes: canonical codes
    with N read as A, DNA16 edge nibbles with N -> 0xF, flipped with the
    strand) equals the de Bruijn oracle of tests/test_debruijn.py on 40
    reads; node_lookup finds present nodes and misses absent ones, and
    code_string inverts the codes."""
    from test_debruijn import oracle_debruijn
    codes = chip_smoke.make_reads(2000, 40, seed=9)
    seqs = [bytes(np.frombuffer(b"ACGTN", np.uint8)[r]).decode()
            for r in codes]
    assert any("N" in s for s in seqs)
    keys, cnt = chip_smoke.graph_nodes(chip_smoke.graph_windows(codes))
    want = oracle_debruijn(seqs, chip_smoke.K)
    assert dict(zip(keys.tolist(), map(tuple, cnt.tolist()))) == want
    assert int(cnt[:, 8].sum()) == codes.shape[0] * (
        chip_smoke.READ_LEN - chip_smoke.K + 1)
    q = np.concatenate([keys[::5], np.array([1 << 41], np.uint64)])
    got, found = chip_smoke.node_lookup(keys, cnt, q)
    assert found[:-1].all() and not found[-1] and not got[-1].any()
    np.testing.assert_array_equal(got[:-1], cnt[::5])
    spec = KmerSpec(chip_smoke.K, DNA)
    for v in keys[:20].tolist():
        assert spec.to_int(spec.from_string(chip_smoke.code_string(v))) == v


def test_p10_model_matches_the_oracle(tmp_path):
    """P10's numpy model (p10_model: canonical codes with N read as A, the
    stored orientation of each key's first window in file order, the
    short ids of its first and last windows) equals the Bimolecule oracle
    of tests/test_bimolecule.py and a per-window Python scan on 60 reads;
    revcomp_codes inverts itself and is the oracle's reverse complement;
    window_ids are the ids the port's short-id marshal gives those windows
    (the values of a KmerValueIndex built from the file)."""
    import oracle
    from kmerind_tpu_torch import KmerValueIndex
    from test_bimolecule import bimol_oracle
    codes = chip_smoke.make_reads(3000, 60, seed=10)
    seqs = [bytes(np.frombuffer(b"ACGTN", np.uint8)[r]).decode()
            for r in codes]
    assert any("N" in s for s in seqs)
    keys, cnts, stored, id_first, id_last = chip_smoke.p10_model(codes)
    assert dict(zip(stored.tolist(), cnts.tolist())) == bimol_oracle(
        seqs, chip_smoke.K)
    nwin = chip_smoke.READ_LEN - chip_smoke.K + 1
    first, last = {}, {}
    for i, s in enumerate(seqs):
        for j, v in enumerate(oracle.canonical_kmers(
                s.replace("N", "A"), chip_smoke.K, kt_dna())):
            first.setdefault(v, i * nwin + j)
            last[v] = i * nwin + j
    assert keys.tolist() == sorted(first)
    np.testing.assert_array_equal(
        id_first, chip_smoke.window_ids(np.array([first[v] for v in
                                                  keys.tolist()])))
    np.testing.assert_array_equal(
        id_last, chip_smoke.window_ids(np.array([last[v] for v in
                                                 keys.tolist()])))
    rc = chip_smoke.revcomp_codes(stored)
    np.testing.assert_array_equal(chip_smoke.revcomp_codes(rc), stored)
    assert rc[:50].tolist() == [oracle.revcomp_int(v, chip_smoke.K, kt_dna())
                                for v in stored[:50].tolist()]
    path = tmp_path / "p10.fastq"
    chip_smoke.write_fastq(codes, chip_smoke.make_quals(codes, 10), path)
    idx = KmerValueIndex(KmerSpec(chip_smoke.K, DNA), device="cpu",
                         reduce="min")
    idx.build(path)
    assert idx.to_dict() == dict(zip(keys.tolist(), id_first.tolist()))


def kt_dna():
    from kmerind_tpu import DNA as JAX_DNA
    return JAX_DNA


@pytest.mark.parametrize("n,hi", [(1, 5), (3000, 40), (5000, 2**62),
                                  (70_000, 2**42)])
def test_occurrences_match_unique(n, hi):
    """P10's occurrences() — one bucket, or several when the codes reach
    past the bits left beside the index — equals np.unique's keys, counts
    and first indices, and the last indices of the reversed array."""
    rng = np.random.default_rng(n)
    canon = rng.integers(0, min(hi, 50 + n // 3), n).astype(np.uint64)
    if hi > 2**32:
        canon = rng.choice(rng.integers(0, hi, 200, dtype=np.uint64), n)
    keys, cnts, first, last = chip_smoke.occurrences(canon)
    want, wfirst, wcnt = np.unique(canon, return_index=True,
                                   return_counts=True)
    np.testing.assert_array_equal(keys, want)
    np.testing.assert_array_equal(cnts, wcnt)
    np.testing.assert_array_equal(first, wfirst)
    _, rfirst = np.unique(canon[::-1], return_index=True)
    np.testing.assert_array_equal(last, n - 1 - rfirst)
