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
