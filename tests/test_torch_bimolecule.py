"""The port's Bimolecule count index (kmerind_tpu_torch.index.api.
BimoleculeCountIndex, store.RunBimolStore) against the JAX package's and
against the pure-Python oracle of tests/test_bimolecule.py (counts by
canonical key, each key reported in the input orientation of its first
occurrence in file order).

The JAX package's own Bimolecule tests read fixtures outside the
repository, so these bring their own seeded FASTQ: reads of mixed lengths
(some shorter than k), both strands, 'N's, cut into chunks that reads
cross.  Each JAX scenario runs once on the conftest's 8-device CPU mesh
(cached with functools.lru_cache) and is held against the port at 1 and 4
shards.  Store functions: the port's against their JAX twins on random
runs with dead rows and inserted (>= 2^63) ids.  Everything is integer:
exact equality throughout (merged runs per key, since the merge keeps
equal keys in no set order)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kmerind_tpu as kt
import kmerind_tpu_torch as kp
from kmerind_tpu.index import store as jst
from kmerind_tpu.index.api import BimoleculeCountIndex as JaxBimol
from kmerind_tpu.io import read_file as jax_read_file
from kmerind_tpu_torch.index import distributed as dx
from kmerind_tpu_torch.index import store as st
from kmerind_tpu_torch.index.convert import bimolecule_index_from_state
from kmerind_tpu_torch.io import read_file as port_read_file

from test_bimolecule import bimol_oracle
from torch_parity import words_np, words_t

COMP = str.maketrans("ACGT", "TGCA")


def revcomp(s: str) -> str:
    return s.translate(COMP)[::-1]


def write_mixed(path, seed: int, n_reads: int = 90,
                genome_len: int = 1500) -> list[str]:
    """Reads of 8-160 bases from a random genome (half reverse-complemented,
    'N' at rate 0.01) as FASTQ; returns the read strings."""
    rng = np.random.default_rng(seed)
    genome = "".join(rng.choice(list("ACGT"), genome_len))
    reads = []
    for _ in range(n_reads):
        n = int(rng.integers(8, 161))
        s = int(rng.integers(0, genome_len - n + 1))
        r = genome[s:s + n]
        if rng.random() < 0.5:
            r = revcomp(r)
        reads.append("".join("N" if rng.random() < 0.01 else c for c in r))
    with open(path, "w") as f:
        for i, r in enumerate(reads):
            f.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")
    return reads


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_bimolecule")
    return d, tuple(write_mixed(d / "a.fastq", seed=9))


# ------------------------------------------------------------ store level
def _bimol_run(rng, n: int, nkeys: int, n_dead_tail: int):
    """A sorted Bimolecule run as numpy columns: n rows over nkeys
    distinct 2-word keys (runs of equal keys), weights 0-3 (0: dead rows
    mid-run), a sentinel tail of n_dead_tail rows, random 64-bit ids — a
    third >= 2^63, as explicit inserts are — with a few ties inside a run,
    random strands."""
    table = rng.integers(0, 2**32, (nkeys, 2), dtype=np.uint32)
    rows = table[rng.integers(0, nkeys, n - n_dead_tail)]
    rows = rows[np.lexsort(rows.T[::-1])]
    keys = np.full((2, n), 0xFFFFFFFF, np.uint32)
    keys[:, :n - n_dead_tail] = rows.T
    weights = rng.integers(0, 4, n).astype(np.int32)
    weights[n - n_dead_tail:] = 0
    ids = rng.integers(0, 2**63, n, dtype=np.uint64)
    ids[rng.random(n) < 1 / 3] |= np.uint64(1 << 63)
    ids[1::17] = ids[0::17][:ids[1::17].shape[0]]   # ties with a neighbour
    strand = rng.integers(0, 2, n).astype(np.uint32)
    return (keys, weights, (ids >> np.uint64(32)).astype(np.uint32),
            ids.astype(np.uint32), strand)


#: the JAX package calls it inside jitted steps; eager, its scan runs op
#: by op (seconds at these sizes)
_jax_min_rep = jax.jit(jst._segmented_min_rep)


def _jax_run(cols):
    return jst.run_bimol_from_sorted(*(jnp.asarray(c) for c in cols))


def _port_run(cols):
    keys, weights, hi, lo, strand = cols
    return st.run_bimol_from_sorted(
        words_t(keys), torch.from_numpy(weights), words_t(hi), words_t(lo),
        words_t(strand))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_segmented_min_rep_matches_jax(seed):
    """Each row's run-minimum representative (id halves and strand) —
    dead rows, inserted ids, ties and all-dead runs included — equals the
    JAX package's associative scan."""
    rng = np.random.default_rng(seed)
    cols = _bimol_run(rng, 3000, 250, 40)
    cols[1][:300] = 0                        # whole runs with no live row
    want = _jax_min_rep(*(jnp.asarray(c) for c in cols))
    got = st._segmented_min_rep(_port_run(cols))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(words_np(g), np.asarray(w))
    np.testing.assert_array_equal(words_np(_port_run(cols).csum),
                                  np.asarray(_jax_run(cols).csum).view(
                                      np.uint32))


def _per_key(keys, *cols):
    """{key tuple: sorted [(col values...)]} over a merged run's rows."""
    out: dict = {}
    for i in range(keys.shape[1]):
        out.setdefault(tuple(keys[:, i].tolist()), []).append(
            tuple(int(c[i]) for c in cols))
    return {k: sorted(v) for k, v in out.items()}


def test_run_bimol_merge_matches_jax():
    """K2 with 4 payloads (its plain version here): the keys equal the JAX
    merge's, every key run holds the same (weight, id, strand) rows, and
    every row reports the same minimum representative and run total."""
    rng = np.random.default_rng(5)
    a, b = _bimol_run(rng, 1500, 200, 30), _bimol_run(rng, 900, 200, 0)
    want = jst.run_bimol_merge(_jax_run(a), _jax_run(b))
    got = st.run_bimol_merge(_port_run(a), _port_run(b))
    keys = np.asarray(want.keys)
    np.testing.assert_array_equal(words_np(got.keys), keys)
    cols = lambda r: [np.asarray(c).view(np.uint32) if not  # noqa: E731
                      isinstance(c, torch.Tensor) else words_np(c)
                      for c in (r.weights, r.rep_hi, r.rep_lo, r.rep_strand)]
    assert _per_key(keys, *cols(got)) == _per_key(keys, *cols(want))
    for g, w in zip(st._segmented_min_rep(got), _jax_min_rep(
            want.keys, want.weights, want.rep_hi, want.rep_lo,
            want.rep_strand)):
        np.testing.assert_array_equal(words_np(g), np.asarray(w))
    np.testing.assert_array_equal(st.run_totals(got)[2].numpy(),
                                  np.asarray(jst.run_totals(want)[2]))


@pytest.mark.parametrize("saturate,new_cap", [(None, 4096), (2, 128)])
def test_run_bimol_lookup_erase_compact_match_jax(saturate, new_cap):
    """find's (count, strand) per query, erase's weights and distinct-key
    count, and compact's every column — into more rows than the run has,
    or fewer than its keys (overflow) — equal the JAX functions'."""
    rng = np.random.default_rng(11)
    cols = _bimol_run(rng, 2048, 300, 100)
    jrun, prun = _jax_run(cols), _port_run(cols)
    keys = cols[0][:, :1900:23].T
    queries = np.concatenate([keys, rng.integers(0, 2**32, (50, 2),
                                                 dtype=np.uint32)])
    jc, js = jst.run_bimol_lookup(jrun, jnp.asarray(queries), saturate)
    ext, bstart = st.run_query_aux(prun)
    pc, ps = st.run_bimol_find_aux(ext, bstart, st.run_bimol_strands(prun),
                                   words_t(queries), saturate)
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(words_np(ps), np.asarray(js))

    qvalid = np.arange(queries.shape[0]) % 5 != 0
    jnew, jn = jst.run_bimol_erase(jrun, jnp.asarray(queries),
                                   jnp.asarray(qvalid))
    stacked = st.stack_stores([prun])
    (pnew,), pn, _ = dx.runs_erase_step(
        [stacked], [[(ext, bstart)]], words_t(queries)[None],
        torch.from_numpy(qvalid)[None])
    assert type(pnew) is st.RunBimolStore and pn == int(jn)
    for f in ("weights", "csum", "rep_hi", "rep_lo", "rep_strand"):
        np.testing.assert_array_equal(
            words_np(getattr(pnew.shard(0), f)),
            np.asarray(getattr(jnew, f)).view(np.uint32), err_msg=f)

    jcomp, jovf = jst.run_bimol_compact(jnew, new_cap, saturate)
    pcomp, povf = st.run_bimol_compact(pnew.shard(0), new_cap, saturate)
    assert povf == int(jovf) and (povf > 0) == (new_cap == 128)
    for f in ("keys", "weights", "csum", "rep_hi", "rep_lo", "rep_strand"):
        np.testing.assert_array_equal(
            words_np(getattr(pcomp, f)),
            np.asarray(getattr(jcomp, f)).view(np.uint32), err_msg=f)


# ------------------------------------------------------------ index level
#: name -> (k, chunk_bases, saturate, the whole surface); k = 20 adds
#: palindromes, saturate= the clamp (held against k21's JAX answers,
#: clamped)
SCENARIOS = {"k21": (21, 1000, None, True), "k20": (20, 2500, None, False),
             "k21_sat": (21, 700, 3, False)}


def _inputs(seqs, k: int):
    """Queries (read windows as given, reverse-complemented, random
    k-mers), keys to erase, and the explicit inserts: 20 present keys in
    the orientation other than the stored one, a palindrome (k even),
    and (k-mer, count) pairs."""
    rng = np.random.default_rng(k)
    wins = []
    for _ in range(120):
        r = seqs[int(rng.integers(len(seqs)))]
        if len(r) >= k:
            i = int(rng.integers(len(r) - k + 1))
            wins.append(r[i:i + k].replace("N", "A"))
    rand = ["".join(rng.choice(list("ACGT"), k)) for _ in range(60)]
    queries = wins + [revcomp(w) for w in wins[:60]] + rand
    pal = ("ACGT" * k)[:k]
    extra = [pal] if k % 2 == 0 and pal == revcomp(pal) else []
    counts = (rand[:20] + wins[:10], rng.integers(1, 9, 30).tolist())
    return dict(queries=queries, gone=wins[60:100] + rand[30:40],
                other=extra, counts=counts)


def _other_orientation(idx_dict, spec_k: int, n: int = 20) -> list[str]:
    """The first n stored keys in their other orientation (as strings)."""
    out = []
    for v in list(idx_dict)[:n]:
        s = "".join("ACGT"[(v >> (2 * (spec_k - 1 - j))) & 3]
                    for j in range(spec_k))
        out.append(revcomp(s))
    return out


def _clamped(want, sat: int) -> dict:
    """A saturating map's answers from an unsaturated one's: every count
    clamped at `sat`, the spectrum's higher bins summed into bin sat."""
    hist = want["hist"].copy()
    hist[sat] = hist[sat:].sum()
    hist[sat + 1:] = 0
    return dict(built={v: min(c, sat) for v, c in want["built"].items()},
                count=np.minimum(want["count"], sat),
                find=(want["find"][0], np.minimum(want["find"][1], sat)),
                hist=hist)


@functools.lru_cache
def _jax_scenario(d, seqs, name):
    k, chunk, sat, whole = SCENARIOS[name]
    if sat is not None:
        return _clamped(_jax_scenario(d, seqs, "k21"), sat)
    inp = _inputs(seqs, k)
    idx = JaxBimol(kt.KmerSpec(k, kt.DNA))
    idx.insert_batch(jax_read_file(d / "a.fastq", kt.DNA), chunk_bases=chunk)
    out = dict(built=idx.to_dict(), count=idx.count(inp["queries"]),
               find=idx.find(inp["queries"]), hist=idx.histogram(50))
    other = _other_orientation(out["built"], k)
    idx.insert(other + inp["other"])
    if not whole:
        out["inserted"] = idx.to_dict()
        return out
    idx.insert_counts(*inp["counts"])
    out.update(inserted=idx.to_dict(), size=idx.size(),
               count_if=sorted(idx.count_if(lambda kk, c: c >= 3)),
               count_if_q=idx.count_if(lambda kk, c: c >= 3,
                                       inp["queries"]))
    out["erased"] = idx.erase(inp["gone"])
    out["erase_if"] = idx.erase_if(lambda kk, c: c == 1)
    out.update(after=idx.to_dict(), after_count=idx.count(inp["queries"]))
    idx.save(d / f"jax_{name}.npz")
    s = idx.store
    out["state"] = tuple(np.asarray(getattr(s, f)) for f in (
        "keys", "weights", "rep_hi", "rep_lo", "rep_strand"))
    return out


@pytest.mark.parametrize("p", [1, 4])
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_bimolecule_index_matches_jax_and_oracle(reads, tmp_path, name, p):
    """The port's index over the file equals the JAX index and the oracle:
    to_dict (stored orientation), count and find of both strands,
    histogram (under saturate=, the JAX answers clamped); then insert of present keys in the other orientation (and a
    palindrome at even k) keeps every stored orientation; on the whole
    surface, insert_counts, size, count_if (all entries and per query),
    erase, erase_if, npz files of either package loading in the other and
    the converter."""
    d, seqs = reads
    k, chunk, sat, whole = SCENARIOS[name]
    want = _jax_scenario(d, seqs, name)
    inp = _inputs(seqs, k)
    idx = kp.BimoleculeCountIndex(kp.KmerSpec(k, kp.DNA), device="cpu",
                                  nparts=p, saturate=sat)
    idx.insert_batch(port_read_file(d / "a.fastq", kp.DNA), chunk_bases=chunk)
    built = idx.to_dict()
    assert built == want["built"]
    if sat is None:
        assert built == bimol_oracle(list(seqs), k)
    np.testing.assert_array_equal(idx.count(inp["queries"]), want["count"])
    for g, w in zip(idx.find(inp["queries"]), want["find"]):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(idx.histogram(50), want["hist"])
    if sat is not None:
        return
    other = _other_orientation(want["built"], k)
    idx.insert(other + inp["other"])
    if whole:
        idx.insert_counts(*inp["counts"])
    got = idx.to_dict()
    assert got == want["inserted"]
    for v in list(want["built"])[:20]:
        assert got[v] == built[v] + 1            # orientation kept
    if not whole:
        return
    assert idx.size() == want["size"]
    assert sorted(idx.count_if(lambda kk, c: c >= 3)) == want["count_if"]
    np.testing.assert_array_equal(
        idx.count_if(lambda kk, c: c >= 3, inp["queries"]), want["count_if_q"])
    assert idx.erase(inp["gone"]) == want["erased"]
    assert idx.erase_if(lambda kk, c: c == 1) == want["erase_if"]
    assert idx.to_dict() == want["after"]
    np.testing.assert_array_equal(idx.count(inp["queries"]),
                                  want["after_count"])
    back = kp.BimoleculeCountIndex.load(d / f"jax_{name}.npz", "cpu",
                                        nparts=p)
    assert back.to_dict() == want["after"]
    idx.save(tmp_path / "port.npz")
    if p > 1:
        # the file does not depend on p; the JAX side loads it once
        return
    jback = JaxBimol.load(tmp_path / "port.npz")
    assert jback.to_dict() == want["after"]
    conv = bimolecule_index_from_state(*want["state"],
                                       spec=kp.KmerSpec(k, kp.DNA),
                                       device="cpu")
    assert conv.nparts == want["state"][0].shape[0]
    assert conv.to_dict() == want["after"]
    np.testing.assert_array_equal(conv.count(inp["queries"]),
                                  want["after_count"])


def test_explicit_inserts_first_occurrence_wins():
    """Both strands answer one entry, stored in the orientation first
    inserted (the reverse strand here); a palindrome stores strand 0; the
    orientation survives reserve(); clear() empties the index."""
    spec = kp.KmerSpec(10, kp.DNA)
    idx = kp.BimoleculeCountIndex(spec, device="cpu", nparts=2)
    idx.insert(["GGGGGGGGGT"])
    idx.insert(["ACCCCCCCCC", "AACGTACGTT"])
    words, counts = idx.find(["ACCCCCCCCC", "AACGTACGTT", "TTTTTTTTTT"])
    got = {spec.to_string(w): int(c) for w, c in zip(words, counts)}
    assert got == {"GGGGGGGGGT": 2, "AACGTACGTT": 1}
    np.testing.assert_array_equal(idx.count(["GGGGGGGGGT", "ACCCCCCCCC"]),
                                  [2, 2])
    cap = idx.capacity
    idx.reserve(100_000)                   # sentinel rows, no representative
    assert idx.capacity > cap
    idx.insert(["ACCCCCCCCC"])
    assert idx.to_dict() == {spec.to_int(spec.from_string(s)): c for s, c in
                             (("GGGGGGGGGT", 3), ("AACGTACGTT", 1))}
    assert idx.clear().size() == 0 and idx.empty()


# ------------------------------------------- the int32 weight guard
def _guarded(saturate=None):
    idx = kp.BimoleculeCountIndex(kp.KmerSpec(9, kp.DNA), device="cpu",
                                  nparts=2, saturate=saturate)
    return idx


def test_note_weight_true_total_reread():
    """The guard's first escape (tests/test_bimolecule.py): the bound
    tightens to the true shard total instead of raising."""
    idx = _guarded()
    idx.insert(["ACGTACGTA"] * 5)
    idx._flush()
    idx._ingested_weight = kp.CountIndex._I32_WEIGHT_GUARD - 1
    idx._note_weight(10)
    assert idx._ingested_weight == 5 + 10
    np.testing.assert_array_equal(idx.count(["ACGTACGTA"]), [5])


def test_note_weight_saturate_compact_escape():
    """Second escape: when even the true total cannot take the weight, a
    saturating map compacts with the clamp and rebounds from size() *
    saturate."""
    idx = _guarded(saturate=3)
    idx.insert(["ACGTACGTA"] * 7 + ["CCCCGGGGA"] * 2)
    idx._flush()
    idx._ingested_weight = kp.CountIndex._I32_WEIGHT_GUARD - 1
    idx._shard_weight = lambda: (1 << 31) - 10     # the re-read, too big
    idx._note_weight(100)
    assert idx._ingested_weight == idx.size() * 3 + 100
    np.testing.assert_array_equal(idx.count(["ACGTACGTA", "CCCCGGGGA"]),
                                  [3, 2])


def test_note_weight_overflow_raises():
    """Final escape: a plain map whose true totals cannot take the
    incoming weight raises before the int32 prefix sums can wrap."""
    idx = _guarded()
    idx.insert(["ACGTACGTA"] * 5)
    idx._flush()
    idx._ingested_weight = kp.CountIndex._I32_WEIGHT_GUARD - 1
    with pytest.raises(OverflowError):
        idx._note_weight((1 << 31) - 2)


def test_balanced_flush_keeps_capacity_bounded():
    """40 pending runs merge two smallest first: the capacity stays a small
    multiple of the rows (one at a time would double it per run)."""
    rng = np.random.default_rng(3)
    idx = kp.BimoleculeCountIndex(kp.KmerSpec(9, kp.DNA), device="cpu",
                                  nparts=4, initial_capacity=1 << 6)
    total = 0
    for _ in range(40):
        s = "".join(rng.choice(list("ACGT"), 24))
        idx.insert([s[j:j + 9] for j in range(16)])
        total += 16
    assert idx.size() > 0
    assert idx.capacity <= 16 * (1 << (total - 1).bit_length())


def test_streamed_build_keeps_file_order(reads):
    """A build streamed in byte blocks numbers each FASTQ record in the
    file (the long ids keep file order across blocks), so the stored
    orientations are the first occurrences, as a whole-file build's.  The
    JAX package numbers a block's records from 0: its streamed Bimolecule
    build keeps the earliest occurrence WITHIN a block's numbering
    instead (ROADMAP queue 3)."""
    d, seqs = reads
    want = bimol_oracle(list(seqs), 21)
    port = kp.BimoleculeCountIndex(kp.KmerSpec(21, kp.DNA), device="cpu",
                                   nparts=2)
    port.build_stream(d / "a.fastq", block_bytes=2000)
    assert port.timer.count("read") > 3
    assert port.to_dict() == want
    jidx = JaxBimol(kt.KmerSpec(21, kt.DNA))
    jidx.build_stream(d / "a.fastq", block_bytes=2000)
    got = jidx.to_dict()
    assert got.keys() != want.keys()
    assert sorted(got.values()) == sorted(want.values())
