"""The CUDA kernels against their plain versions on the card, at small and
edge-case shapes (empty runs, one row, key widths 1-9 in registers and 17,
33, 129 past them with 0-8 payloads, k up to 1024, sums that wrap, runs
crossing every tile, no valid rows; for K1 every alphabet on both sides of
the 64- and 128-bit rolling states and on the wide kernel above them,
sizes around both tiles and a thread's segment, n < k, all-palindrome
input, unaligned views, repeated calls; for the K2 merge ties across every
tile boundary (and past the staged key words), lopsided, disjoint and
sentinel runs, totals around the tile size, row-major runs (K2′); for the
K3 scan sizes around its tile, look-back over many tiles, repeated calls,
unaligned views; for K4 a run over 10,000 tiles, tv at a tile boundary,
unaligned views, repeated calls; the de Bruijn graphs' edge-byte payloads
and 0 / 1 counter streams), and the port's indexes on the card against the
same index on the CPU: CountIndex (one shard, 4 hashed shards, k = 81 and
127), SortedCountIndex, the multimaps (k up to 128), both de Bruijn
graphs (k = 21 and 127, 1 and 4 shards), BimoleculeCountIndex (K2 with 4
payloads: weight, full 32-bit id halves, strand) and both value maps under
each reduction (k = 21 and 127, 1 and 4 shards).
Exact equality throughout (qualities aside): everything else is integer,
and the K2 merge keeps ties in the plain version's (stable) order.

Needs an NVIDIA GPU and nvcc; skips otherwise.  Pure PyTorch (no JAX), so
it runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

import kmerind_tpu_torch as kp
from kmerind_tpu_torch.io import read_file
from kmerind_tpu_torch.ops import kernels, packing

from torch_parity import sorted_key_cols, words_t, write_reads

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    kernels.build()
    return torch.device("cuda")


K1_TILE = 2048     # windows per tile of the rolling K1 kernels (kTile)
K1_ITEMS = 16      # windows per thread (kItems)
K1_WIDE_TILE = 1024   # windows per tile of the wide K1 kernel (kWideTile)


def _k1_check(dev, codes, spec, launches=1):
    """K1 on a uint8 CUDA tensor `codes`: shapes, `launches` launches
    counted, words and was_rc of every whole window bitwise equal to the
    plain version on the CPU."""
    before = kernels.LAUNCHES["extract_canonical"]
    w, rc = kernels.extract_canonical(codes, spec)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["extract_canonical"] == before + launches
    n = codes.shape[0]
    assert w.shape == (n, spec.nwords) and rc.shape == (n,)
    pw, prc = packing.extract_canonical(codes.cpu(), spec)
    nv = max(n - spec.k + 1, 0)
    assert torch.equal(w[:nv].cpu(), pw[:nv])
    assert torch.equal(rc[:nv].cpu(), prc[:nv])
    return rc[:nv]


# every alphabet on both sides of the 64- and 128-bit rolling states (DNA
# 32/33, 64/65; DNA5/6 21/22, 42/43; DNA16 16/17, 32/33; ASCII 8/9,
# 16/17), the widest word counts (DNA5 k=21: 3 words, k=42: 5), and the
# wide kernel on every alphabet up to k=1024
@pytest.mark.parametrize("name,k", [
    ("DNA", 1), ("DNA", 21), ("DNA", 32), ("DNA", 33), ("DNA", 63),
    ("DNA", 64), ("DNA", 65), ("RNA", 16), ("DNA5", 11), ("DNA5", 21),
    ("DNA5", 42), ("DNA6", 21), ("DNA6", 22), ("DNA6", 42), ("DNA6", 43),
    ("RNA6", 31), ("DNA16", 9), ("DNA16", 16), ("DNA16", 17),
    ("DNA16", 32), ("DNA16", 33), ("DNA_IUPAC", 15), ("ASCII", 5),
    ("ASCII", 8), ("ASCII", 9), ("ASCII", 16), ("ASCII", 17),
    ("DNA", 512), ("DNA", 127), ("DNA", 128), ("DNA", 1024), ("RNA", 100),
    ("DNA5", 43), ("DNA5", 200), ("RNA6", 43), ("DNA16", 100),
    ("DNA_IUPAC", 33), ("ASCII", 100), ("ASCII", 513), ("ASCII", 1024)])
@pytest.mark.parametrize("n", [1, 300, 70001, "T-1", "T", "T+1", "T+k-1",
                               "S*m-1", "S*m+1"])
def test_extract_canonical_kernel(dev, name, k, n):
    """Sizes around the tile (T), a tile plus the halo, and a thread's
    segment (S); n % 4 != 0 puts word columns 1.. off 16 bytes."""
    spec = kp.KmerSpec(k, kp.alphabets.by_name(name))
    if isinstance(n, str):
        n = {"T-1": K1_TILE - 1, "T": K1_TILE, "T+1": K1_TILE + 1,
             "T+k-1": K1_TILE + k - 1, "S*m-1": K1_ITEMS * 37 - 1,
             "S*m+1": K1_ITEMS * 37 + 1}[n]
    codes = np.random.default_rng(n + k).integers(
        0, spec.alphabet.size, n).astype(np.uint8)
    _k1_check(dev, torch.from_numpy(codes).to(dev), spec)


def test_k1_tile_matches_the_source(dev):
    lib = kernels._cuda_lib()
    assert lib.kmerind_extract_canonical_tile() == K1_TILE
    assert lib.kmerind_extract_wide_tile() == K1_WIDE_TILE


@pytest.mark.parametrize("n", [K1_WIDE_TILE - 1, K1_WIDE_TILE,
                               K1_WIDE_TILE + 1, "3T+k-1", "3T+k",
                               "5T-k"])
@pytest.mark.parametrize("name,k", [("DNA", 65), ("DNA", 127),
                                    ("DNA6", 300), ("ASCII", 1024)])
def test_extract_canonical_wide_tile_sizes(dev, name, k, n):
    """The wide kernel at sizes around its tile, with the halo of the last
    whole tile in the input or cut by its end; one launch on "wide"."""
    spec = kp.KmerSpec(k, kp.alphabets.by_name(name))
    assert kernels.k1_kernel(spec) == "wide"
    if isinstance(n, str):
        n = {"3T+k-1": 3 * K1_WIDE_TILE + k - 1, "3T+k": 3 * K1_WIDE_TILE + k,
             "5T-k": 5 * K1_WIDE_TILE - k}[n]
    codes = np.random.default_rng(n * 7 + k).integers(
        0, spec.alphabet.size, n).astype(np.uint8)
    before = kernels.K1_LAUNCHES["wide"]
    _k1_check(dev, torch.from_numpy(codes).to(dev), spec)
    assert kernels.K1_LAUNCHES["wide"] == before + 1


@pytest.mark.parametrize("name,k,n", [
    ("DNA", 21, 5), ("DNA", 64, 63), ("DNA16", 33, 1), ("DNA", 127, 100),
    ("DNA", 1024, 1000), ("ASCII", 513, 3)])
def test_extract_canonical_shorter_than_k(dev, name, k, n):
    """n < k: no whole window; the kernel runs and reads no code past the
    end (the rows are garbage, the shapes are right)."""
    spec = kp.KmerSpec(k, kp.alphabets.by_name(name))
    codes = torch.randint(0, spec.alphabet.size, (n,), dtype=torch.uint8)
    _k1_check(dev, codes.to(dev), spec)


@pytest.mark.parametrize("name,k", [("DNA", 2), ("DNA", 20), ("DNA", 32),
                                    ("DNA", 64), ("DNA", 100),
                                    ("DNA16", 30), ("DNA", 128),
                                    ("DNA", 1024), ("DNA16", 64)])
def test_extract_canonical_all_palindromes(dev, name, k):
    """A T A T ... (DNA16: the same letters): every window of even k is its
    own reverse complement, so every was_rc is False (ties take the
    forward strand)."""
    alpha = kp.alphabets.by_name(name)
    codes = np.resize(alpha.encode("AT"), 3 * K1_TILE + 5)
    spec = kp.KmerSpec(k, alpha)
    rc = _k1_check(dev, torch.from_numpy(codes).to(dev), spec)
    assert not rc.any()


@pytest.mark.parametrize("offset", range(1, 16))
@pytest.mark.parametrize("name,k", [("DNA", 21), ("DNA", 63),
                                    ("ASCII", 16), ("DNA", 127),
                                    ("ASCII", 40)])
def test_extract_canonical_unaligned_views(dev, offset, name, k):
    """Codes that start `offset` bytes into a larger tensor (a shard of the
    sorted index starts at s * L bytes), n % 4 == 3."""
    spec = kp.KmerSpec(k, kp.alphabets.by_name(name))
    n = 2 * K1_TILE + 3
    big = torch.randint(0, spec.alphabet.size, (n + 32,), dtype=torch.uint8,
                        generator=torch.Generator().manual_seed(offset))
    _k1_check(dev, big.to(dev)[offset:offset + n], spec)


def test_extract_canonical_repeated_calls(dev):
    """Calls in a row, the same shapes, other codes: each equals the plain
    version."""
    spec = kp.KmerSpec(21, kp.DNA)
    gen = torch.Generator().manual_seed(7)
    for _ in range(3):
        codes = torch.randint(0, 4, (5 * K1_TILE + 17,), dtype=torch.uint8,
                              generator=gen)
        _k1_check(dev, codes.to(dev), spec)


@pytest.mark.parametrize("w,npay,na,nb", [
    (1, 0, 0, 0), (1, 1, 0, 5), (2, 0, 5, 0), (2, 3, 1, 1),
    (2, 1, 1000, 3), (3, 2, 3, 1000), (4, 0, 4096, 4096),
    (5, 3, 20001, 7777), (2, 0, 1 << 16, 8212), (6, 4, 3000, 2999),
    (7, 0, 1, 5000), (8, 3, 20001, 7777), (9, 8, 4097, 4095),
    (17, 0, 5000, 3), (33, 4, 9000, 7001), (129, 8, 2047, 2049),
    (129, 0, 0, 700)])
def test_merge_runs_kernel(dev, w, npay, na, nb):
    rng = np.random.default_rng(w * 100 + npay + na)
    a = words_t(sorted_key_cols(rng, w, na, n_sentinel=min(na, 3)))
    b = words_t(sorted_key_cols(rng, w, nb, n_sentinel=min(nb, 2)))
    pa = tuple(torch.from_numpy(rng.integers(-9, 9, na).astype(np.int32))
               for _ in range(npay))
    pb = tuple(torch.from_numpy(rng.integers(-9, 9, nb).astype(np.int32))
               for _ in range(npay))
    want_k, want_p = kernels.merge_runs_cols_plain(a, pa, b, pb)
    got_k, got_p = kernels.merge_runs_cols(
        a.to(dev), tuple(p.to(dev) for p in pa),
        b.to(dev), tuple(p.to(dev) for p in pb))
    torch.cuda.synchronize()
    assert torch.equal(got_k.cpu(), want_k)
    assert all(torch.equal(g.cpu(), p) for g, p in zip(got_p, want_p))


MERGE_TILE = 1024   # outputs per CTA of merge_runs.cu (kTile)
SCAN_TILE = 8192    # values per tile of prefix_sum.cu (kTile)


def test_tile_sizes_match_the_sources(dev):
    lib = kernels._cuda_lib()
    assert lib.kmerind_merge_runs_parts(MERGE_TILE, 0) == 2
    assert lib.kmerind_merge_runs_parts(0, MERGE_TILE + 1) == 3
    assert lib.kmerind_merge_runs_parts(0, 0) == 1
    assert lib.kmerind_prefix_sum_scratch_words(SCAN_TILE) == 2
    assert lib.kmerind_prefix_sum_scratch_words(SCAN_TILE + 1) == 3


def _tied_run(rng, w, n, lo, hi, n_sentinel=0):
    """uint32[w, n] ascending run: word 0 in [lo, hi), the other words 0 or
    1, so equal keys repeat; `n_sentinel` all-ones rows at the tail."""
    live = n - n_sentinel
    cols = [rng.integers(lo, hi, live, dtype=np.uint32)]
    cols += [rng.integers(0, 2, live, dtype=np.uint32) for _ in range(w - 1)]
    order = np.lexsort(cols[::-1])
    keys = np.full((w, n), 0xFFFFFFFF, np.uint32)
    keys[:, :live] = np.stack([c[order] for c in cols])
    return keys


def _check_merge(dev, a, b, npay):
    """K2 on uint32 runs a, b with distinct payloads (A rows 0.., B rows
    after them), so any tie taken out of order shows: bitwise equal to the
    plain version's stable merge, one launch counted."""
    na, nb = a.shape[1], b.shape[1]
    pa = tuple(torch.arange(na, dtype=torch.int32) + p for p in range(npay))
    pb = tuple(torch.arange(na, na + nb, dtype=torch.int32) + p
               for p in range(npay))
    at, bt = words_t(a), words_t(b)
    want_k, want_p = kernels.merge_runs_cols_plain(at, pa, bt, pb)
    before = kernels.LAUNCHES["merge_runs_cols"]
    got_k, got_p = kernels.merge_runs_cols(
        at.to(dev), tuple(p.to(dev) for p in pa),
        bt.to(dev), tuple(p.to(dev) for p in pb))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["merge_runs_cols"] == before + 1
    assert torch.equal(got_k.cpu(), want_k)
    assert all(torch.equal(g.cpu(), p) for g, p in zip(got_p, want_p))


@pytest.mark.parametrize("w,npay,na,nb,nvals", [
    (1, 1, 5 * MERGE_TILE + 37, 3 * MERGE_TILE + 11, 10),
    (2, 3, 4 * MERGE_TILE - 1, 4 * MERGE_TILE + 1, 3),
    (5, 2, 9 * MERGE_TILE + 5, 2 * MERGE_TILE, 2),
    (2, 1, 100_003, 99_997, 1000), (6, 0, 3 * MERGE_TILE + 7, MERGE_TILE, 4),
    (9, 5, 5 * MERGE_TILE + 1, 3 * MERGE_TILE - 1, 3),
    (17, 2, 4 * MERGE_TILE + 9, 2 * MERGE_TILE + 3, 3),
    (33, 4, 3 * MERGE_TILE - 5, 3 * MERGE_TILE + 5, 2),
    (129, 8, 2 * MERGE_TILE + 1, MERGE_TILE - 1, 2)])
def test_merge_ties_straddle_every_tile_boundary(dev, w, npay, na, nb, nvals):
    """Few distinct keys: every tile boundary falls inside a run of ties
    between A and B."""
    rng = np.random.default_rng(na + nb + w)
    _check_merge(dev, _tied_run(rng, w, na, 0, nvals),
                 _tied_run(rng, w, nb, 0, nvals), npay)


@pytest.mark.parametrize("w,na,nb", [
    (1, 7 * MERGE_TILE + 5, 5 * MERGE_TILE + 3), (3, 6 * MERGE_TILE, 0),
    (2, 1, 8 * MERGE_TILE + 9)])
def test_merge_equal_keys_longer_than_many_tiles(dev, w, na, nb):
    """One key value in both runs: the whole merge is ties, A first."""
    a = np.full((w, na), 12345, np.uint32)
    b = np.full((w, nb), 12345, np.uint32)
    _check_merge(dev, a, b, 2)


@pytest.mark.parametrize("na,nb,a_range,b_range", [
    (200_001, 7, (0, 50), (0, 50)),              # na >> nb
    (5, 150_000, (0, 50), (0, 50)),              # nb >> na
    (30_000, 20_000, (0, 1000), (2000, 3000)),   # all of A below all of B
    (30_000, 20_000, (2000, 3000), (0, 1000)),   # all of A above all of B
])
def test_merge_lopsided_and_disjoint_runs(dev, na, nb, a_range, b_range):
    rng = np.random.default_rng(na * 3 + nb)
    _check_merge(dev, _tied_run(rng, 2, na, *a_range),
                 _tied_run(rng, 2, nb, *b_range), 1)


@pytest.mark.parametrize("na,nb,a_sent,b_sent", [
    (3000, 2000, 3000, 0),          # A all sentinel
    (4097, 5000, 0, 5000),          # B all sentinel
    (2048, 2048, 2048, 2048),       # both all sentinel
    (6000, 7000, 1500, 4000)])      # sentinel tails inside both runs
def test_merge_sentinel_runs(dev, na, nb, a_sent, b_sent):
    """Sentinel rows inside a run are ordinary keys with their payloads."""
    rng = np.random.default_rng(na + b_sent)
    _check_merge(dev, _tied_run(rng, 2, na, 0, 100, a_sent),
                 _tied_run(rng, 2, nb, 0, 100, b_sent), 2)


@pytest.mark.parametrize("total", [4 * MERGE_TILE - 1, 4 * MERGE_TILE,
                                   4 * MERGE_TILE + 1])
@pytest.mark.parametrize("w,npay", [(1, 0), (2, 1), (3, 3), (8, 6),
                                    (33, 4), (129, 1)])
def test_merge_totals_around_the_tile(dev, total, w, npay):
    """na + nb at T*m - 1, T*m, T*m + 1: a last tile of T - 1, T or 1 rows,
    and a sentinel fill of 1, 0 or T*m - 1 rows (unaligned head and tail)."""
    rng = np.random.default_rng(total + w)
    na = total // 3
    _check_merge(dev, _tied_run(rng, w, na, 0, 500),
                 _tied_run(rng, w, total - na, 0, 500), npay)


@pytest.mark.parametrize("n", [1, 2047, 2048, 2049, SCAN_TILE - 1, SCAN_TILE,
                               SCAN_TILE + 1, 300_000, 5_000_001])
def test_prefix_sum_kernel(dev, n):
    x = torch.from_numpy(np.random.default_rng(n).integers(
        -(2**31), 2**31 - 1, n, dtype=np.int64).astype(np.int32))
    got = kernels.prefix_sum_i32(x.to(dev))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), kernels.prefix_sum_i32_plain(x))


def test_prefix_sum_look_back_over_many_tiles(dev):
    """2^26 values (8,192 tiles): look-back may reach past 32 tiles; sums
    wrap modulo 2^32 many times."""
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randint(-(2**31), 2**31 - 1, (1 << 26,), dtype=torch.int32,
                      device=dev, generator=gen)
    assert torch.equal(kernels.prefix_sum_i32(x),
                       kernels.prefix_sum_i32_plain(x))


def test_prefix_sum_wraps(dev):
    x = torch.full((3 * SCAN_TILE + 5,), 2**30, dtype=torch.int32)
    got = kernels.prefix_sum_i32(x.to(dev)).cpu()
    np.testing.assert_array_equal(
        got.numpy(), np.cumsum(x.numpy(), dtype=np.int32))


def test_prefix_sum_twice_resets_its_scratch(dev):
    """Two calls in a row with the same scratch size: the tile counter and
    the status flags start from zero each time."""
    gen = torch.Generator(device=dev).manual_seed(4)
    x = torch.randint(0, 100, (7 * SCAN_TILE + 3,), dtype=torch.int32,
                      device=dev, generator=gen)
    y = torch.randint(0, 100, x.shape, dtype=torch.int32, device=dev,
                      generator=gen)
    before = kernels.LAUNCHES["prefix_sum_i32"]
    gx, gy = kernels.prefix_sum_i32(x), kernels.prefix_sum_i32(y)
    assert kernels.LAUNCHES["prefix_sum_i32"] == before + 2
    assert torch.equal(gx, kernels.prefix_sum_i32_plain(x))
    assert torch.equal(gy, kernels.prefix_sum_i32_plain(y))


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_prefix_sum_unaligned_views(dev, offset):
    """A contiguous view that starts off a 16-byte boundary takes the
    scalar path."""
    x = torch.arange(3 * SCAN_TILE + 17, dtype=torch.int32, device=dev)
    v = x[offset:]
    assert torch.equal(kernels.prefix_sum_i32(v),
                       kernels.prefix_sum_i32_plain(v))


@pytest.mark.parametrize("w,npay,na,nb", [
    (1, 0, 0, 3), (2, 1, 1000, 3), (3, 2, 3, 1000), (5, 3, 20001, 7777),
    (4, 1, 5 * MERGE_TILE + 3, 3 * MERGE_TILE), (6, 0, 2049, 2047),
    (7, 2, 10_000, 1), (8, 1, 3 * MERGE_TILE - 1, 3 * MERGE_TILE + 1),
    (9, 4, 4000, 4000), (12, 3, 3001, 2999), (33, 0, 2048, 1000)])
def test_merge_sorted_runs_kernel(dev, w, npay, na, nb):
    """K2′: the row-major entry (row-major loads and stores, no transposes),
    its own launch counter."""
    rng = np.random.default_rng(w * 10 + na)
    a = words_t(sorted_key_cols(rng, w, na).T)
    b = words_t(sorted_key_cols(rng, w, nb, n_sentinel=min(nb, 2)).T)
    pa = tuple(torch.from_numpy(rng.integers(-9, 9, na).astype(np.int32))
               for _ in range(npay))
    pb = tuple(torch.from_numpy(rng.integers(-9, 9, nb).astype(np.int32))
               for _ in range(npay))
    want_k, want_p = kernels.merge_sorted_runs_plain(a, pa, b, pb)
    before = dict(kernels.LAUNCHES)
    got_k, got_p = kernels.merge_sorted_runs(
        a.to(dev), tuple(p.to(dev) for p in pa),
        b.to(dev), tuple(p.to(dev) for p in pb))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["merge_sorted_runs"] == \
        before["merge_sorted_runs"] + 1
    assert kernels.LAUNCHES["merge_runs_cols"] == before["merge_runs_cols"]
    assert got_k.shape == want_k.shape and got_k.is_contiguous()
    assert torch.equal(got_k.cpu(), want_k)
    assert all(torch.equal(g.cpu(), p) for g, p in zip(got_p, want_p))


def _rl_case(rng, n, w, nkeys, tv):
    """[w, n] columns: a sorted valid prefix of tv rows, random tail."""
    keys = rng.integers(0, 2**32, (max(nkeys, 1), w), dtype=np.uint32)
    rows = keys[rng.integers(0, max(nkeys, 1), n)]
    pre = rows[:tv]
    rows[:tv] = pre[np.lexsort(pre.T[::-1])]
    return rows.T


RL_TILE = 2048      # rows per tile of run_length_weights.cu (kTile)


@pytest.mark.parametrize("n,w,nkeys,tv", [
    (1, 1, 1, 1), (1, 2, 1, 0), (2047, 2, 3, 2047), (2048, 1, 1, 2048),
    (2049, 3, 2, 0), (2049, 4, 2, 1), (70001, 5, 9, 69999),
    (300_000, 2, 7, 270_000), (1 << 20, 2, 1000, 1 << 20),
    (5_000_001, 1, 1, 5_000_001),
    (5 * RL_TILE, 2, 4, 3 * RL_TILE - 1), (5 * RL_TILE, 2, 4, 3 * RL_TILE),
    (5 * RL_TILE, 3, 4, 3 * RL_TILE + 1)])
def test_run_length_weights_kernel(dev, n, w, nkeys, tv):
    """K4 at tv = 0, 1, n, at a tile boundary +-1 and in between; one run
    covering everything; few keys, so runs cross every 2048-row tile;
    w = 1..5; n not a multiple of the tile (and n % 4 != 0: key columns
    1.. start off 16 bytes)."""
    cols = words_t(_rl_case(np.random.default_rng(n + w), n, w, nkeys, tv))
    tvt = torch.tensor(tv, dtype=torch.int32)
    want = kernels.run_length_weights_plain(cols, tvt)
    before = kernels.LAUNCHES["run_length_weights"]
    got = kernels.run_length_weights(cols.to(dev), tvt.to(dev))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["run_length_weights"] == before + 1
    assert torch.equal(got.cpu(), want)
    assert int(want.sum()) == tv


def test_run_length_weights_every_tile_boundary(dev):
    """Runs of 2047, 2049 and 4096 rows, laid end to end: every tile
    boundary falls inside a run, some runs start or end on one; the first
    invalid row equals the last valid one."""
    lens = np.tile([2047, 2049, 4096, 1, 2], 40)
    keys = np.repeat(np.arange(lens.size, dtype=np.uint32), lens)
    n = keys.size
    cols = words_t(np.stack([keys // 7, keys]))
    tv = n - 3
    want = kernels.run_length_weights_plain(cols, tv)
    got = kernels.run_length_weights(
        cols.to(dev), torch.tensor(tv, dtype=torch.int32, device=dev))
    assert torch.equal(got.cpu(), want)
    assert int(want.sum()) == tv and int(want[tv - 1]) > 0


def test_run_length_weights_run_over_10000_tiles(dev):
    """One run of 10,000 tiles and a bit, then short runs: every tile in
    the long run has no head, and the run's end needs the start 10,000
    tiles back."""
    n = 10_003 * RL_TILE
    keys = torch.zeros((2, n), dtype=torch.int32, device=dev)
    tail = torch.arange(n - (10_000 * RL_TILE + 77), device=dev)
    keys[1, 10_000 * RL_TILE + 77:] = (tail // 5 + 1).to(torch.int32)
    tv = torch.tensor(n - 9, dtype=torch.int32, device=dev)
    got = kernels.run_length_weights(keys, tv)
    assert torch.equal(got, kernels.run_length_weights_plain(keys, tv))
    assert int(got[10_000 * RL_TILE + 76]) == 10_000 * RL_TILE + 77


def test_run_length_weights_unaligned_view(dev):
    """Key columns in a contiguous view that starts 4 bytes into a larger
    tensor: every column start is off 16 bytes."""
    rng = np.random.default_rng(11)
    n, w = 3 * RL_TILE + 5, 3
    cols = words_t(_rl_case(rng, n, w, 40, n - 2))
    big = torch.zeros(w * n + 1, dtype=torch.int32, device=dev)
    view = big[1:].view(w, n)
    view.copy_(cols.to(dev))
    tv = torch.tensor(n - 2, dtype=torch.int32, device=dev)
    assert torch.equal(kernels.run_length_weights(view, tv).cpu(),
                       kernels.run_length_weights_plain(cols, n - 2))


def test_run_length_weights_repeated_calls(dev):
    """Calls in a row with the same shapes and other keys: each equals the
    plain version (nothing carries from one call to the next)."""
    rng = np.random.default_rng(12)
    before = kernels.LAUNCHES["run_length_weights"]
    for nkeys in (3, 300, 1):
        cols = words_t(_rl_case(rng, 9 * RL_TILE + 1, 2, nkeys, 9 * RL_TILE))
        tv = torch.tensor(9 * RL_TILE, dtype=torch.int32)
        got = kernels.run_length_weights(cols.to(dev), tv.to(dev))
        assert torch.equal(got.cpu(), kernels.run_length_weights_plain(cols, tv))
    assert kernels.LAUNCHES["run_length_weights"] == before + 3


def test_wrappers_reject_bad_input(dev):
    spec = kp.KmerSpec(21, kp.DNA)
    with pytest.raises(TypeError):
        kernels.extract_canonical(torch.zeros(10, dtype=torch.int32,
                                              device=dev), spec)
    with pytest.raises(ValueError):
        kernels.extract_canonical(torch.zeros((2, 10), dtype=torch.uint8,
                                              device=dev), spec)
    with pytest.raises(ValueError):
        kernels.prefix_sum_i32(torch.zeros((4, 4), dtype=torch.int32,
                                           device=dev)[:, 0])
    a = torch.zeros((6, 4), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        kernels.merge_runs_cols(a, (), a[:5].contiguous(), ())
    with pytest.raises(ValueError):
        kernels.merge_runs_cols(a, (a[0],), a, ())
    with pytest.raises(ValueError):
        kernels.merge_sorted_runs(a, (), a[:, :3].contiguous(), ())
    with pytest.raises(ValueError):
        kernels.run_length_weights(a[:, :2], torch.tensor(
            2, dtype=torch.int32, device=dev))
    with pytest.raises(TypeError):
        kernels.run_length_weights(a, torch.tensor(2, device=dev))


def test_count_index_cuda_matches_cpu(dev, tmp_path):
    path = tmp_path / "reads.fastq"
    reads = write_reads(path, 400, 150, 3000, seed=2, n_rate=0.002)
    spec = kp.KmerSpec(21, kp.DNA)
    idx = {}
    for d in ("cpu", dev):
        idx[d] = kp.CountIndex(spec, device=d, max_runs=2)
        idx[d].insert_batch(read_file(path, kp.DNA), chunk_bases=7000)
    q = [r[i:i + 21] for r in reads[:50] for i in (0, 40, 129)]
    q += ["ACGT" * 5 + "A"] * 3
    np.testing.assert_array_equal(idx[dev].count(q), idx["cpu"].count(q))
    assert idx[dev].to_dict() == idx["cpu"].to_dict()
    assert idx[dev].size() == idx["cpu"].size()
    idx[dev].compact(1 << 15)
    idx["cpu"].compact(1 << 15)
    assert idx[dev].to_dict() == idx["cpu"].to_dict()


def test_sorted_count_index_cuda_matches_cpu(dev, tmp_path):
    """4 shards: K1 and K4 per shard and chunk, the flush's exchange and
    sorts on the card; the same contents, splitters and answers as on the
    CPU."""
    path = tmp_path / "reads.fastq"
    reads = write_reads(path, 400, 150, 3000, seed=4, n_rate=0.002)
    spec = kp.KmerSpec(21, kp.DNA)
    idx = {}
    for d in ("cpu", dev):
        before = kernels.LAUNCHES["run_length_weights"]
        idx[d] = kp.SortedCountIndex(spec, device=d, nparts=4)
        idx[d].insert_batch(read_file(path, kp.DNA), chunk_bases=7000)
    assert kernels.LAUNCHES["run_length_weights"] - before == \
        4 * idx[dev].timer.count("insert") >= 4 * 8
    q = [r[i:i + 21] for r in reads[:50] for i in (0, 40, 129)]
    np.testing.assert_array_equal(idx[dev].count(q), idx["cpu"].count(q))
    assert idx[dev].to_dict() == idx["cpu"].to_dict()
    np.testing.assert_array_equal(idx[dev].splitter_table(),
                                  idx["cpu"].splitter_table())
    assert idx[dev].erase(q[:20]) == idx["cpu"].erase(q[:20])
    assert idx[dev].size() == idx["cpu"].size()


@pytest.mark.parametrize("hash_name", ["murmur", "farm"])
def test_count_index_shards_cuda_matches_cpu(dev, tmp_path, hash_name):
    """4 hash-partitioned shards: owners, exchange and per-shard merges on
    the card give the same shards as on the CPU."""
    path = tmp_path / "reads.fastq"
    reads = write_reads(path, 400, 150, 3000, seed=5, n_rate=0.002)
    spec = kp.KmerSpec(21, kp.DNA)
    idx = {}
    for d in ("cpu", dev):
        idx[d] = kp.CountIndex(spec, device=d, nparts=4, max_runs=2,
                               hash_name=hash_name)
        idx[d].insert_batch(read_file(path, kp.DNA), chunk_bases=7000)
    q = [r[i:i + 21] for r in reads[:50] for i in (0, 40, 129)]
    np.testing.assert_array_equal(idx[dev].count(q), idx["cpu"].count(q))
    for got, want in zip(idx[dev].items(), idx["cpu"].items()):
        np.testing.assert_array_equal(got, want)
    assert idx[dev].local_sizes() == idx["cpu"].local_sizes()


@pytest.mark.parametrize("cls,k,p", [("PositionQualityIndex", 21, 4),
                                     ("PositionIndex", 32, 2),
                                     ("SortedPositionQualityIndex", 21, 4)])
def test_multimap_cuda_matches_cpu(dev, tmp_path, cls, k, p):
    """The multimaps on the card against the same index on the CPU: the
    hash family's flushes run K2 with 2-3 payloads (the flagged merge at
    k=32), small `flush_rows` making several of them.  The same pairs
    (qualities at rtol 1e-6: exp2 on the card and on the CPU may round
    apart), counts, find id sets and erase."""
    path = tmp_path / "reads.fastq"
    reads = write_reads(path, 400, 150, 3000, seed=6, n_rate=0.002,
                        varied_quality=True)
    spec = kp.KmerSpec(k, kp.DNA)
    idx = {}
    for d in ("cpu", dev):
        before = kernels.LAUNCHES["merge_runs_cols"]
        idx[d] = getattr(kp, cls)(spec, device=d, nparts=p, canonical=True)
        idx[d].flush_rows = 1 << 13
        idx[d].insert_batch(read_file(path, kp.DNA), chunk_bases=7000)
        idx[d].size()
    if cls.startswith("Position"):
        flushes = idx[dev].timer.count("merge")
        assert kernels.LAUNCHES["merge_runs_cols"] - before >= flushes * p > p
    (gk, gi, gq), (wk, wi, wq) = idx[dev].pairs(), idx["cpu"].pairs()
    go, wo = np.argsort(gi), np.argsort(wi)
    np.testing.assert_array_equal(gi[go], wi[wo])
    np.testing.assert_array_equal(gk[go], wk[wo])
    np.testing.assert_array_equal(gq[go] == 0, wq[wo] == 0)
    np.testing.assert_allclose(gq[go], wq[wo], rtol=1e-6)
    q = [r[i:i + k] for r in reads[:50] for i in (0, 40, 100)]
    np.testing.assert_array_equal(idx[dev].count(q), idx["cpu"].count(q))
    (gi, gm), (wi, wm) = (idx[d].find(q, max_per_query=4)
                          for d in (dev, "cpu"))
    for i in range(len(q)):
        assert sorted(gi[i][gm[i]]) == sorted(wi[i][wm[i]])
    assert idx[dev].erase(q[:20]) == idx["cpu"].erase(q[:20]) > 0
    assert idx[dev].size() == idx["cpu"].size()


@pytest.mark.parametrize("k", [64, 80, 81, 127, 128])
def test_multimap_merge_width_on_card(dev, tmp_path, k):
    """Every hash-multimap flush on the card goes through K2, at any key
    width: k = 64 (the flag plus 4 full words), 80 (the flag plus 5), 81
    (6 words), 127 (8) and 128 (the flag plus 8: 9 key columns) merge on
    the card and match the CPU."""
    path = tmp_path / "reads.fastq"
    write_reads(path, 200, 150, 3000, seed=7, n_rate=0.002)
    spec = kp.KmerSpec(k, kp.DNA)
    idx = {}
    for d in ("cpu", dev):
        idx[d] = kp.PositionIndex(spec, device=d, nparts=2)
        idx[d].insert_batch(read_file(path, kp.DNA), chunk_bases=7000)
    before = kernels.LAUNCHES["merge_runs_cols"]
    assert idx[dev].size() == idx["cpu"].size() > 0
    assert kernels.LAUNCHES["merge_runs_cols"] - before >= 2
    assert idx[dev].to_dict() == idx["cpu"].to_dict()


@pytest.mark.parametrize("k", [81, 127])
def test_count_index_wide_cuda_matches_cpu(dev, tmp_path, k):
    """CountIndex at 6 and 8 key words: K1's wide kernel per chunk and K2's
    merges at w = 6 / 8 on the card give the CPU's contents and counts."""
    path = tmp_path / "reads.fastq"
    reads = write_reads(path, 300, 150, 2000, seed=8, n_rate=0.002)
    spec = kp.KmerSpec(k, kp.DNA)
    idx = {}
    for d in ("cpu", dev):
        before = dict(kernels.LAUNCHES)
        idx[d] = kp.CountIndex(spec, device=d, max_runs=2)
        idx[d].insert_batch(read_file(path, kp.DNA), chunk_bases=7000)
    assert kernels.LAUNCHES["merge_runs_cols"] - before["merge_runs_cols"] \
        >= idx[dev].timer.count("merge") >= 2
    assert kernels.LAUNCHES["extract_canonical"] - \
        before["extract_canonical"] == idx[dev].timer.count("insert")
    q = [r[i:i + k].replace("N", "A") for r in reads[:60]
         for i in (0, 150 - k)]
    np.testing.assert_array_equal(idx[dev].count(q), idx["cpu"].count(q))
    assert idx[dev].to_dict() == idx["cpu"].to_dict()
    assert idx[dev].size() == idx["cpu"].size()


@pytest.mark.parametrize("na,nb,zeros", [
    (5 * MERGE_TILE + 17, 3 * MERGE_TILE - 1, 0.0),
    (200_003, 150_001, 0.3), (1, 40_000, 0.5)])
def test_merge_weighted_count_runs(dev, na, nb, zeros):
    """K2 with ONE payload, the count index's weights, on runs whose
    weights are not all 1 (0 where a row was erased, else 1-1000): bitwise
    equal to the plain version, counted under one payload; the merged
    store's prefix sum (K3) equals the CPU's."""
    from kmerind_tpu_torch.index import store as st
    rng = np.random.default_rng(na + nb)

    def run(n):
        keys = words_t(_tied_run(rng, 2, n, 0, 3000, n // 50))
        w = rng.integers(1, 1001, n).astype(np.int32)
        w[rng.random(n) < zeros] = 0
        w[n - n // 50:] = 0                    # sentinel tail: weight 0
        return keys, torch.from_numpy(w)

    (ak, aw), (bk, bw) = run(na), run(nb)
    before = kernels.K2_PAYLOAD_LAUNCHES.get(1, 0)
    got = st.run_merge(st.run_from_sorted(ak.to(dev), aw.to(dev)),
                       bk.to(dev), bw.to(dev))
    torch.cuda.synchronize()
    assert kernels.K2_PAYLOAD_LAUNCHES[1] == before + 1
    want = st.run_merge(st.run_from_sorted(ak, aw), bk, bw)
    for f in ("keys", "weights", "csum"):
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f


@pytest.mark.parametrize("n,hi", [(SCAN_TILE * 3 + 1, 1001),
                                  (1 << 22, 1 << 10), (777_777, 2)])
def test_prefix_sum_nonnegative_weights(dev, n, hi):
    """K3 on arbitrary non-negative weights (zeros among them, as erase and
    filter leave): bitwise equal to the plain version."""
    w = np.random.default_rng(n).integers(0, hi, n).astype(np.int32)
    w[::7] = 0
    x = torch.from_numpy(w)
    got = kernels.prefix_sum_i32(x.to(dev))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), kernels.prefix_sum_i32_plain(x))


@pytest.mark.parametrize("p", [1, 4])
def test_count_surface_cuda_matches_cpu(dev, tmp_path, p):
    """insert_counts, erase, a build after it, filter, count_if, histogram,
    saturate and the npz / checkpoint round trips on the card give the
    CPU's answers; K2 merged with the weights as its one payload and K3
    ran."""
    from kmerind_tpu_torch.utils.checkpoint import load_index, save_index
    path = tmp_path / "reads.fastq"
    reads = write_reads(path, 400, 150, 3000, seed=9, n_rate=0.002)
    spec = kp.KmerSpec(21, kp.DNA)
    q = [r[i:i + 21] for r in reads[:80] for i in (0, 40, 129)]
    cnt = np.arange(len(q)) % 997
    kernels.reset_launches()
    answers = {}
    for d in ("cpu", dev):
        idx = kp.CountIndex(spec, device=d, nparts=p, max_runs=2)
        idx.insert_batch(read_file(path, kp.DNA), chunk_bases=7000)
        idx.insert_counts(q, cnt)
        a = [idx.count(q), idx.erase(q[:60])]
        idx.insert_batch(read_file(path, kp.DNA), chunk_bases=7000)
        a += [idx.filter(lambda k, c: c >= 2), idx.histogram(50),
              sorted(idx.count_if(lambda k, c: c > 20)), idx.count(q)]
        idx.save(tmp_path / f"{p}.npz")
        a.append(kp.CountIndex.load(tmp_path / f"{p}.npz", d).count(q))
        save_index(idx, tmp_path / f"ck{p}")
        a.append(load_index(tmp_path / f"ck{p}", d).to_dict())
        sat = kp.CountIndex(spec, device=d, nparts=p, saturate=4)
        sat.insert_batch(read_file(path, kp.DNA), chunk_bases=7000)
        a += [sat.count(q), sat.histogram(8), sat.to_dict()]
        answers[d] = a
    for got, want in zip(answers[dev], answers["cpu"]):
        if isinstance(want, np.ndarray):
            np.testing.assert_array_equal(got, want)
        else:
            assert got == want
    assert kernels.K2_PAYLOAD_LAUNCHES.get(1, 0) > 0
    assert kernels.LAUNCHES["prefix_sum_i32"] > 0


def test_multimap_predicates_cuda_matches_cpu(dev, tmp_path):
    """PositionQualityIndex and SortedPositionIndex predicates on the card:
    count_if, erase_if on window quality, keyed erase_if and filter give
    the CPU's answers."""
    path = tmp_path / "reads.fastq"
    reads = write_reads(path, 300, 150, 3000, seed=10, n_rate=0.002,
                        varied_quality=True)
    spec = kp.KmerSpec(21, kp.DNA)
    q = [r[i:i + 21] for r in reads[:40] for i in (0, 100)]
    for cls in (kp.PositionQualityIndex, kp.SortedPositionIndex):
        answers = {}
        for d in ("cpu", dev):
            idx = cls(spec, device=d, nparts=4, canonical=True)
            idx.insert_batch(read_file(path, kp.DNA), chunk_bases=7000)
            answers[d] = [
                idx.count_if(lambda k, h, l, x: (l & 1) == 0),
                idx.erase_if(lambda k, h, l, x: x < 0.9),
                idx.erase_if(lambda k, h, l, x: (l & 3) == 1, q),
                idx.filter(lambda k, h, l, x: (k[:, 0] >> 31) == 0),
                idx.size()]
        assert answers[dev] == answers["cpu"]


# ------------------------------------------------------- the de Bruijn graphs
@pytest.mark.parametrize("npay,na,nb", [
    (1, 4 * MERGE_TILE - 1, 4 * MERGE_TILE + 1), (1, MERGE_TILE, MERGE_TILE),
    (2, 5 * MERGE_TILE + 3, 3 * MERGE_TILE - 3), (2, 1, 2 * MERGE_TILE),
    (1, 100_003, 99_997)])
def test_merge_edge_byte_payloads(dev, npay, na, nb):
    """The graph's merges: key ties across every tile edge, edge bytes
    (0-255) as the one payload of a unit merge, (edge byte, weight) as 2:
    bitwise equal to the plain (stable) merge."""
    rng = np.random.default_rng(na + npay)
    a, b = words_t(_tied_run(rng, 2, na, 0, 40)), words_t(
        _tied_run(rng, 2, nb, 0, 40))

    def pays(n):
        eb = torch.from_numpy(rng.integers(0, 256, n).astype(np.int32))
        wt = torch.from_numpy(rng.integers(1, 9, n).astype(np.int32))
        return (eb, wt)[:npay]

    pa, pb = pays(na), pays(nb)
    want_k, want_p = kernels.merge_runs_cols_plain(a, pa, b, pb)
    before = dict(kernels.K2_PAYLOAD_LAUNCHES)
    got_k, got_p = kernels.merge_runs_cols(
        a.to(dev), tuple(p.to(dev) for p in pa),
        b.to(dev), tuple(p.to(dev) for p in pb))
    torch.cuda.synchronize()
    assert kernels.K2_PAYLOAD_LAUNCHES[npay] == before.get(npay, 0) + 1
    assert torch.equal(got_k.cpu(), want_k)
    assert all(torch.equal(g.cpu(), p) for g, p in zip(got_p, want_p))


@pytest.mark.parametrize("n", [SCAN_TILE - 1, SCAN_TILE, SCAN_TILE + 1,
                               3 * SCAN_TILE - 1, 3 * SCAN_TILE + 1,
                               (1 << 22) + 5])
@pytest.mark.parametrize("density", [0.0, 0.25, 1.0])
def test_prefix_sum_bit_streams(dev, n, density):
    """K3 on the graph's 0 / 1 counter streams around its tile size."""
    rng = np.random.default_rng(n + int(density * 4))
    x = torch.from_numpy((rng.random(n) < density).astype(np.int32))
    got = kernels.prefix_sum_i32(x.to(dev))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), kernels.prefix_sum_i32_plain(x))


@pytest.mark.parametrize("k,p", [(21, 1), (21, 4), (127, 1), (127, 4)])
def test_debruijn_graphs_cuda_match_cpu(dev, tmp_path, k, p):
    """Both graphs built on the card (K1 per chunk, K2 unit and weighted
    merges, K3 tables) answer as on the CPU; the quality sums agree at
    rtol 1e-6 (float32 window qualities, float64 prefix sums)."""
    path = tmp_path / "reads.fastq"
    write_reads(path, 300, 160, 2500, seed=k + p, n_rate=0.01,
                varied_quality=True)
    spec = kp.KmerSpec(k, kp.DNA)
    for cls in (kp.DeBruijnGraph, kp.QualityDeBruijnGraph):
        g = {}
        for d in ("cpu", dev):
            g[d] = cls(spec, device=d, nparts=p, max_runs=2)
            g[d].insert_batch(read_file(path, kp.ASCII), chunk_bases=6000)
        want, got = g["cpu"].items(), g[dev].items()
        for a, b in zip(got[:2], want[:2]):
            np.testing.assert_array_equal(a, b)
        if cls is kp.QualityDeBruijnGraph:
            np.testing.assert_allclose(got[2], want[2], rtol=1e-6)
        words = want[0][::7]
        np.testing.assert_array_equal(g[dev].node_counts(words)[0],
                                      g["cpu"].node_counts(words)[0])
        for d in ("cpu", dev):
            g[d].compact()
            g[d].insert_batch(read_file(path, kp.ASCII), chunk_bases=6000)
        np.testing.assert_array_equal(g[dev].items()[1], g["cpu"].items()[1])


# ----------------------------------------- Bimolecule and the value maps
@pytest.mark.parametrize("na,nb", [
    (4 * MERGE_TILE - 1, 4 * MERGE_TILE + 1), (MERGE_TILE, MERGE_TILE),
    (5 * MERGE_TILE + 3, 1), (100_003, 99_997)])
def test_merge_bimolecule_payloads(dev, na, nb):
    """Bimolecule's merges: K2 at w=2 with 4 payloads — weight, both id
    halves as full 32-bit patterns (-1 on the sentinel tail), strand —,
    key ties across every tile edge: bitwise equal to the plain (stable)
    merge, counted under 4 payloads."""
    rng = np.random.default_rng(na + nb)
    a = words_t(_tied_run(rng, 2, na, 0, 50, n_sentinel=min(na, 5)))
    b = words_t(_tied_run(rng, 2, nb, 0, 50, n_sentinel=min(nb, 1)))

    def pays(keys):
        n = keys.shape[1]
        live = ~(keys == -1).all(dim=0)
        full = lambda: torch.from_numpy(  # noqa: E731
            rng.integers(0, 2**32, n, dtype=np.uint32).view(np.int32))
        return (torch.where(live, torch.from_numpy(
                    rng.integers(0, 4, n).astype(np.int32)), 0),
                torch.where(live, full(), -1), torch.where(live, full(), -1),
                torch.where(live, torch.from_numpy(
                    rng.integers(0, 2, n).astype(np.int32)), 0))

    pa, pb = pays(a), pays(b)
    want_k, want_p = kernels.merge_runs_cols_plain(a, pa, b, pb)
    before = dict(kernels.K2_PAYLOAD_LAUNCHES)
    got_k, got_p = kernels.merge_runs_cols(
        a.to(dev), tuple(p.to(dev) for p in pa),
        b.to(dev), tuple(p.to(dev) for p in pb))
    torch.cuda.synchronize()
    assert kernels.K2_PAYLOAD_LAUNCHES[4] == before.get(4, 0) + 1
    assert torch.equal(got_k.cpu(), want_k)
    assert all(torch.equal(g.cpu(), p) for g, p in zip(got_p, want_p))


@pytest.mark.parametrize("k,p", [(21, 1), (21, 4), (127, 1), (127, 4)])
def test_bimolecule_cuda_matches_cpu(dev, tmp_path, k, p):
    """BimoleculeCountIndex on the card (K1 per chunk, K2 with 4 payloads
    per merge — w = 8 at k = 127 —, K3 per adopted run) answers as on the
    CPU: stored orientations, counts, find of both strands, inserts of the
    other orientation, erase, compact, the npz file."""
    path = tmp_path / "reads.fastq"
    write_reads(path, 300, 160, 2500, seed=k + p, n_rate=0.01)
    spec = kp.KmerSpec(k, kp.DNA)
    answers = {}
    before = dict(kernels.K2_PAYLOAD_LAUNCHES)
    for d in ("cpu", dev):
        idx = kp.BimoleculeCountIndex(spec, device=d, nparts=p)
        idx.flush_rows = 4000
        idx.insert_batch(read_file(path, kp.DNA), chunk_bases=6000)
        rows, cnts = idx.items()
        q = np.concatenate([rows[::5], rows[1::5]])
        idx.insert(q[:40])
        answers[d] = [rows, cnts, idx.count(q), *idx.find(q),
                      idx.erase(q[::3]), idx.size(), *idx.items()]
        idx.compact()
        idx.save(tmp_path / f"{d}.npz")
        back = kp.BimoleculeCountIndex.load(tmp_path / f"{d}.npz", d)
        answers[d] += [*back.items()]
    assert kernels.K2_PAYLOAD_LAUNCHES.get(4, 0) > before.get(4, 0)
    for g, w in zip(answers[dev], answers["cpu"]):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("k,p", [(21, 1), (21, 4), (127, 1), (127, 4)])
@pytest.mark.parametrize("reduce", ["first", "min", "max"])
def test_value_maps_cuda_match_cpu(dev, tmp_path, k, p, reduce):
    """KmerValueIndex and SortedKmerValueIndex on the card (K1 per chunk,
    the sorts and the routed lookups) answer as on the CPU."""
    path = tmp_path / "reads.fastq"
    write_reads(path, 300, 160, 2500, seed=k + p, n_rate=0.01)
    spec = kp.KmerSpec(k, kp.DNA)
    for cls in (kp.KmerValueIndex, kp.SortedKmerValueIndex):
        answers, q = {}, None
        for d in ("cpu", dev):
            idx = cls(spec, device=d, nparts=p, reduce=reduce)
            idx.insert_batch(read_file(path, kp.DNA), chunk_bases=6000)
            built = idx.to_dict()
            if q is None:
                q = [spec.from_int(int(v)) for v in list(built)[::4]]
                vals = np.random.default_rng(k).integers(
                    0, 2**64, len(q), dtype=np.uint64)
            idx.insert(q + q[:10], np.concatenate([vals, vals[:10] + 1]))
            answers[d] = [built, idx.to_dict(), *idx.find(q),
                          idx.erase_if(lambda kk, h, lo: (lo & 1) == 1),
                          idx.erase(q[::3]), idx.to_dict()]
        for g, w in zip(answers[dev], answers["cpu"]):
            if isinstance(w, dict):
                assert g == w
            else:
                np.testing.assert_array_equal(g, w)


def test_dryrun_multichip_on_the_card(dev):
    """The multi-process dry run with its shards on the card: one rank per
    card over NCCL where there are two cards, else two ranks sharing
    cuda:0 over gloo."""
    from kmerind_tpu_torch.parallel.multihost import dryrun_multichip
    if torch.cuda.device_count() >= 2:
        out = dryrun_multichip(2)
        assert out["backend"] == "nccl"
    else:
        out = dryrun_multichip(2, device="cuda:0", backend="gloo")
        assert out["device"] == "cuda:0" and out["backend"] == "gloo"
    assert out["ranks"] == 2 and out["windows"] == 8 * (60 - 21 + 1)
    assert 0 < out["size"] <= out["windows"]
