"""The port's de Bruijn graphs against the JAX package's, on the CPU.

* ``debruijn/edges.py`` against ``kmerind_tpu.debruijn.edges``;
* the run-layout node stores (``store.RunVecStore`` / ``RunVecQStore``)
  against their JAX twins: tables, unit and weighted merges, lookup,
  distinct, compaction;
* both graphs against the JAX graphs (the conftest's 8-device CPU mesh) on
  a seeded FASTQ with 'N's, records shorter than k and reads that cross
  chunk boundaries, at p = 1 and 4, canonical and not, several chunk
  sizes, raw and pre-encoded batches; and against the oracle of
  ``tests/test_debruijn.py``;
* npz files across the packages, ``convert.debruijn_graph_from_state``,
  ``IndexConfig(index="debruijn")``, ``save_index`` / ``load_index``, the
  chunk and FASTA-block readers' left halo.

Counters and keys: exact.  Quality sums: the port keeps its quality prefix
in float64.  Against the JAX package's float32 prefix differences they
agree at rtol 1e-3 (the ROADMAP's parity rule) with an absolute slack of
16 float32 ulps of the run's quality total, the rounding such a difference
carries; against float64 numpy sums at rtol 1e-6 (of the same float32
values) and 1e-5 (of float64 window qualities from the phred bytes: the
port's float32 window quality is good to ~1e-6)."""

import collections
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kmerind_tpu as kt
import kmerind_tpu_torch as kp
from kmerind_tpu.config import IndexConfig as JaxIndexConfig
from kmerind_tpu.debruijn import DeBruijnGraph as JaxGraph
from kmerind_tpu.debruijn import QualityDeBruijnGraph as JaxQGraph
from kmerind_tpu.debruijn import edges as jedges
from kmerind_tpu.index import distributed as jdx
from kmerind_tpu.index import store as jst
from kmerind_tpu.io import files as jfiles
from kmerind_tpu.io import read_file as jax_read_file
from kmerind_tpu.parallel.mesh import make_mesh
from kmerind_tpu_torch.debruijn import edges as tedges
from kmerind_tpu_torch.index import distributed as tdx
from kmerind_tpu_torch.index import store as tst
from kmerind_tpu_torch.index.convert import debruijn_graph_from_state
from kmerind_tpu_torch.io import files as tfiles
from kmerind_tpu_torch.io import read_file as port_read_file
from kmerind_tpu_torch.utils.checkpoint import load_index, save_index

from test_debruijn import oracle_debruijn
from torch_parity import assert_batches_equal, sorted_key_cols, words_np, \
    words_t

K = 21
SPEC = kp.KmerSpec(K, kp.DNA)
JSPEC = kt.KmerSpec(K, kt.DNA)
QRTOL = 1e-3


def _write_fastq(path, seed: int, n_reads: int = 70, genome_len: int = 500,
                 quals: list | None = None):
    """Reads of 5-130 bases sampled from a random genome (half reverse-
    complemented, so nodes recur on both strands), 'N' at 2 %, phred
    qualities 2-41 (mostly high; 2 on every N) drawn from the seed, each
    read's appended to `quals`; about 1 in 8 records is shorter than k.
    Returns the read strings."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, genome_len)
    reads = []
    with open(path, "w") as f:
        for i in range(n_reads):
            n = int(rng.integers(5, 20) if rng.random() < 0.125
                    else rng.integers(K, 131))
            s = int(rng.integers(0, genome_len - n + 1))
            codes = genome[s:s + n]
            if rng.random() < 0.5:
                codes = 3 - codes[::-1]
            seq = np.frombuffer(b"ACGT", np.uint8)[codes].copy()
            seq[rng.random(n) < 0.02] = ord("N")
            q = 41 - np.minimum(rng.geometric(0.15, n) - 1, 39)
            q[seq == ord("N")] = 2
            if quals is not None:
                quals.append(q)
            q = q + 33
            r = bytes(seq).decode()
            reads.append(r)
            f.write(f"@r{i}\n{r}\n+\n{bytes(q.astype(np.uint8)).decode()}\n")
    return reads


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_debruijn") / "reads.fastq"
    return path, _write_fastq(path, seed=81)


def _quality_oracle(seqs, quals, canonical: bool) -> dict:
    """{kmer_int: float64 sum of its windows' qualities}: each window's
    quality the product of 1 - 10^(-q/10) over its phred scores (none is
    0 here), independent of the port's tables."""
    codes_of = {c: i for i, c in enumerate("ACGT")}
    out = collections.defaultdict(float)
    for seq, q in zip(seqs, quals):
        p = 1.0 - 10.0 ** (-q.astype(np.float64) / 10.0)
        for i in range(len(seq) - K + 1):
            v = 0
            for c in seq[i:i + K]:
                v = 4 * v + codes_of.get(c, 0)
            if canonical:
                rc = 0
                for c in reversed(seq[i:i + K]):
                    rc = 4 * rc + 3 - codes_of.get(c, 0)
                v = min(v, rc)
            out[v] += float(np.prod(p[i:i + K]))
    return dict(out)


# ------------------------------------------------------------------- edges
@pytest.mark.parametrize("raw", [True, False])
@pytest.mark.parametrize("k", [3, 21])
def test_edge_bytes_match_jax(raw, k):
    rng = np.random.default_rng(k + raw)
    n = 3000
    codes = (rng.choice(np.frombuffer(b"ACGTNacgtn-", np.uint8), n) if raw
             else rng.integers(0, 4, n).astype(np.uint8))
    valid = rng.random(n) > 0.03
    seg = np.cumsum(rng.random(n) < 0.02).astype(np.int32)
    want = np.asarray(jedges.edge_bytes_for_windows(
        jnp.asarray(codes), jnp.asarray(valid), jnp.asarray(seg), k,
        kt.DNA, raw=raw))
    got = tedges.edge_bytes_for_windows(
        torch.from_numpy(codes), torch.from_numpy(valid),
        torch.from_numpy(seg), k, kp.DNA, raw=raw)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want & 0xF == 0xF).any() == raw   # 'N' neighbours: all four


def test_edge_byte_transforms_match_jax():
    e = np.arange(256, dtype=np.uint8)
    got = tedges.revcomp_edge_byte(torch.from_numpy(e)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jedges.revcomp_edge_byte(jnp.asarray(e))))
    np.testing.assert_array_equal(
        tedges.revcomp_edge_byte(torch.from_numpy(got)).numpy(), e)
    np.testing.assert_array_equal(
        tedges.edge_byte_to_vec(torch.from_numpy(e)).numpy(),
        np.asarray(jedges.edge_byte_to_vec(jnp.asarray(e))))
    for name in ("DNA", "DNA5", "DNA16", "RNA"):
        np.testing.assert_array_equal(
            tedges.dna16_code_lut(kp.alphabets.by_name(name)),
            jedges.dna16_code_lut(kt.alphabets.by_name(name)))


# ------------------------------------------------------------- node stores
def _edge_run(seed, cap=3000, n_sentinel=200, unit=False, w=2):
    """(keys uint32[w, cap], ebytes, weights, qsums) numpy columns of a
    sorted edge run: ~cap / 8 distinct keys, sentinel tail of weight 0;
    unit: weight 1 on every live row."""
    rng = np.random.default_rng(seed)
    keys = sorted_key_cols(rng, w, cap, hi_values=400, n_sentinel=n_sentinel)
    live = cap - n_sentinel
    keys[1:, :live] %= 3
    keys[:, :live] = keys[:, np.lexsort(keys[::-1, :live])]
    eb = rng.integers(0, 256, cap).astype(np.int32)
    wt = (np.ones(cap, np.int32) if unit
          else rng.integers(0, 5, cap).astype(np.int32))
    wt[live:] = 0
    eb[live:] = 0
    qs = rng.random(cap).astype(np.float32) * (wt > 0)
    return keys, eb, wt, qs


def _jax_run(cols, quality, unit=False):
    keys, eb, wt, qs = (jnp.asarray(c) for c in cols)
    if quality:
        f = jst.run_vecq_from_sorted_unit if unit else jst.run_vecq_from_sorted
        return f(keys, eb, wt, qs)
    f = jst.run_vec_from_sorted_unit if unit else jst.run_vec_from_sorted
    return f(keys, eb, wt)


def _port_run(cols, quality, unit=False, table=True):
    keys, eb, wt, qs = cols
    args = (words_t(keys), torch.from_numpy(eb), torch.from_numpy(wt))
    if quality:
        f = tst.run_vecq_from_sorted_unit if unit else tst.run_vecq_from_sorted
        return f(*args, torch.from_numpy(qs), table=table)
    f = tst.run_vec_from_sorted_unit if unit else tst.run_vec_from_sorted
    return f(*args, table=table)


def _queries(*key_sets, seed=0, n_absent=200):
    """uint32[m, w] queries: every key of the runs once, and absent ones."""
    rng = np.random.default_rng(seed)
    present = np.unique(np.concatenate([k.T for k in key_sets]), axis=0)
    present = present[~(present == 0xFFFFFFFF).all(axis=1)]
    absent = rng.integers(0, 2**32, (n_absent, present.shape[1]),
                          dtype=np.uint32)
    return np.concatenate([present, absent])


def _jax_lookup(run, q, quality):
    if quality:
        c, s = jst.run_vecq_lookup(run, jnp.asarray(q))
        return np.asarray(c), np.asarray(s)
    return np.asarray(jst.run_vec_lookup(run, jnp.asarray(q))), None


def _port_lookup(run, q):
    c, s = tst.run_vec_lookup(run, words_t(q))
    return c.numpy(), None if s is None else s.numpy()


def _same_answers(got, want, total):
    """Port (counters, qsum) == JAX's: counters exact, quality sums within
    rtol 1e-3 plus 16 float32 ulps of the run's quality total."""
    np.testing.assert_array_equal(got[0], want[0])
    if want[1] is not None:
        np.testing.assert_allclose(
            got[1], want[1], rtol=QRTOL,
            atol=16 * float(np.spacing(np.float32(total))))


def test_vec_tables_match_jax():
    _, eb, wt, _ = _edge_run(1)
    got = tst._vec_bsum(torch.from_numpy(eb), torch.from_numpy(wt))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jst._vec_bsum(jnp.asarray(eb),
                                              jnp.asarray(wt))))
    n_live = 2800
    eb[n_live:] = 0
    got = tst._vec_bsum_unit(torch.from_numpy(eb), torch.tensor(n_live))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jst._vec_bsum_unit(jnp.asarray(eb),
                                                   jnp.int32(n_live))))


@pytest.mark.parametrize("quality", [False, True])
@pytest.mark.parametrize("unit", [False, True])
def test_vec_lookup_and_distinct_match_jax(quality, unit):
    cols = _edge_run(2, unit=unit)
    j, t = _jax_run(cols, quality, unit), _port_run(cols, quality, unit)
    np.testing.assert_array_equal(t.bsum.numpy(), np.asarray(j.bsum))
    assert int(tst.run_vec_distinct(t)) == int(jst.run_vec_distinct(j))
    q = _queries(cols[0])
    got = _port_lookup(t, q)
    _same_answers(got, _jax_lookup(j, q, quality), cols[3].sum())
    if quality:
        # against float64 sums of the same float32 values
        keys, qs = cols[0], cols[3].astype(np.float64)
        want = collections.Counter()
        for i, key in enumerate(map(tuple, keys.T.tolist())):
            want[key] += qs[i]
        np.testing.assert_allclose(
            got[1], [want.get(tuple(r), 0.0) for r in q.tolist()],
            rtol=1e-6, atol=1e-9)


def _by_key(run):
    """{key: Counter of (edge byte, weight)} of a run's live rows."""
    out = collections.defaultdict(collections.Counter)
    keys, eb, wt = (np.asarray(x) if not torch.is_tensor(x) else
                    (words_np(x) if x.dim() == 2 else x.numpy())
                    for x in (run.keys, run.ebytes, run.weights))
    for i in np.flatnonzero(wt > 0):
        out[tuple(keys[:, i].tolist())][(int(eb[i]), int(wt[i]))] += 1
    return dict(out)


@pytest.mark.parametrize("quality", [False, True])
@pytest.mark.parametrize("unit", [False, True])
def test_vec_merges_match_jax(quality, unit):
    """Unit merges (K2 with the edge byte, + the quality bits) and weighted
    ones (+ the weights): the same keys in order, the same (edge byte,
    weight) rows per key, the same answers; a LAZY merge's table equals
    the eager one's."""
    ca = _edge_run(3, cap=2000, n_sentinel=100, unit=unit)
    cb = _edge_run(4, cap=900, n_sentinel=30, unit=unit)
    ja, jb = _jax_run(ca, quality, unit), _jax_run(cb, quality, unit)
    ta, tb = _port_run(ca, quality, unit), _port_run(cb, quality, unit)
    if unit:
        merge = jst.run_vecq_merge_unit if quality else jst.run_vec_merge_unit
        want = merge(ja, jb)
        got = tst.run_vec_merge_unit(ta, tb)
        lazy = tst.run_vec_merge_unit(ta, tb, table=False)
    else:
        want = (jst.run_vecq_merge if quality else jst.run_vec_merge)(ja, jb)
        got = tst.run_vec_merge(ta, tb)
        lazy = tst.run_vec_merge(ta, tb, table=False)
    np.testing.assert_array_equal(words_np(got.keys), np.asarray(want.keys))
    np.testing.assert_array_equal(got.weights.numpy(),
                                  np.asarray(want.weights)) if unit else None
    assert _by_key(got) == _by_key(want)
    q = _queries(ca[0], cb[0])
    total = ca[3].sum() + cb[3].sum()
    _same_answers(_port_lookup(got, q), _jax_lookup(want, q, quality), total)
    assert lazy.bsum is None
    for closed_form in {False, unit}:   # a unit run's table, either way
        full = tst.run_vec_with_table(lazy, unit=closed_form)
        np.testing.assert_array_equal(full.bsum.numpy(), got.bsum.numpy())
    if quality:
        assert lazy.qcsum is None
        np.testing.assert_array_equal(full.qcsum.numpy(), got.qcsum.numpy())


@pytest.mark.parametrize("quality", [False, True])
@pytest.mark.parametrize("new_cap", [4096, 64])
def test_vec_compact_matches_jax(quality, new_cap):
    """Equal (key, edge byte) rows collapse into one weighted row: the same
    overflow, the same groups and answers (when they fit)."""
    cols = _edge_run(5)
    j, t = _jax_run(cols, quality), _port_run(cols, quality)
    jnew, jovf = (jst.run_vecq_compact if quality
                  else jst.run_vec_compact)(j, new_cap)
    tnew, tovf = tst.run_vec_compact(t, new_cap)
    assert tovf == int(jovf) and tnew.capacity == new_cap
    assert tnew.bsum is None                  # a LAZY run
    if tovf:
        return
    assert _by_key(tnew) == _by_key(jnew)
    tnew = tst.run_vec_with_table(tnew)
    assert int(tst.run_vec_distinct(tnew)) == int(jst.run_vec_distinct(j))
    q = _queries(cols[0])
    _same_answers(_port_lookup(tnew, q), _jax_lookup(jnew, q, quality),
                  cols[3].sum())
    _same_answers(_port_lookup(tnew, q), _port_lookup(t, q), cols[3].sum())


def test_vecq_lazy_adopt_known_divergence():
    """Known reference fault (ROADMAP queue 3): the JAX package's
    make_run_vecq_adopt_step builds the tables of a non-unit run although
    table=False.  The port honours the flag (a LAZY run, no tables) and,
    once the tables are built, answers as the JAX run does."""
    keys, eb, wt, qs = _edge_run(6)
    j = jdx.make_run_vecq_adopt_step(make_mesh(1), unit=False, table=False)(
        *(jnp.asarray(c)[None] for c in (keys, eb, wt, qs)))
    assert j.bsum is not None and j.qcsum is not None       # the fault
    t = tdx.run_vec_adopt_step(
        words_t(keys)[None], torch.from_numpy(eb)[None],
        torch.from_numpy(wt)[None], torch.from_numpy(qs)[None],
        unit=False, table=False)
    assert t.bsum is None and t.qcsum is None
    t = tdx.run_vec_table_step(t)
    q = _queries(keys)
    jrun = jst.RunVecQStore(**{f: getattr(j, f)[0] for f in (
        "keys", "ebytes", "weights", "qsums", "bsum", "qcsum")})
    _same_answers(_port_lookup(t.shard(0), q), _jax_lookup(jrun, q, True),
                  qs.sum())


def test_vecq_float32_prefix_known_divergence():
    """Known reference fault (ROADMAP queue 3): the JAX quality store keeps
    its quality prefix sums in float32, and a node's sum is a difference
    of two prefixes, so it loses the node's digits once the run's total
    dwarfs the node's sum.  2^20 rows, one node per 30 rows, qualities in
    [0.8, 1): the JAX lookups are off by more than 1e-3 relative, the
    port's (float64 prefix) by less than 1e-6."""
    n, per = 1 << 20, 30
    rng = np.random.default_rng(7)
    keys = np.zeros((2, n), np.uint32)
    keys[1] = np.arange(n) // per
    eb, wt = np.zeros(n, np.int32), np.ones(n, np.int32)
    qs = rng.uniform(0.8, 1.0, n).astype(np.float32)
    nodes = rng.choice(n // per, 2000, replace=False)
    q = np.stack([np.zeros(nodes.size, np.uint32),
                  nodes.astype(np.uint32)], 1)
    want = np.array([qs[v * per:(v + 1) * per].astype(np.float64).sum()
                     for v in nodes])
    cols = (keys, eb, wt, qs)
    _, jsum = _jax_lookup(_jax_run(cols, True), q, True)
    _, tsum = _port_lookup(_port_run(cols, True), q)
    assert np.max(np.abs(jsum - want) / want) > 1e-3      # the fault
    np.testing.assert_allclose(tsum, want, rtol=1e-6)


# ------------------------------------------------------------------ graphs
@functools.lru_cache(maxsize=None)
def _jax_graph(path: str, p: int, canonical: bool, quality: bool = False,
               encoded: bool = False):
    """A JAX graph built from the file (raw) or from its batch pre-encoded
    in DNA (encoded), with its to_dict()."""
    cls = JaxQGraph if quality else JaxGraph
    g = cls(JSPEC, mesh=make_mesh(p), canonical=canonical)
    if encoded:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            g.insert_batch(jax_read_file(path, kt.DNA))
    else:
        g.build(path)
    jax.block_until_ready(g.runs)
    return g, g.to_dict()


def _port_graph(path, p, canonical, quality=False, chunk=None, **kw):
    cls = kp.QualityDeBruijnGraph if quality else kp.DeBruijnGraph
    g = cls(SPEC, device="cpu", nparts=p, canonical=canonical, **kw)
    if chunk is not None:
        g.default_chunk_bases = chunk
    return g.build(path)


def _same_dict(got: dict, want: dict, quality: bool):
    """Port to_dict() == JAX's: counters exact, quality sums as in
    `_same_answers` (the slack from the sum of every node's sum)."""
    assert got.keys() == want.keys()
    if not quality:
        assert got == want
        return
    for key, val in want.items():
        assert got[key][:10] == val[:10]
    total = sum(v[10] for v in want.values())
    np.testing.assert_allclose(
        [got[k][10] for k in want], [want[k][10] for k in want], rtol=QRTOL,
        atol=16 * float(np.spacing(np.float32(total))))


@pytest.mark.parametrize("canonical", [True, False])
@pytest.mark.parametrize("p,chunk", [(1, None), (1, 211), (4, None),
                                     (4, 700)])
def test_graph_matches_jax_and_oracle(reads, p, canonical, chunk):
    """to_dict() equals the JAX graph's and the oracle's at every chunk
    size: the left and right halos keep each window's edges across chunk
    (and shard) boundaries; small chunks force LSM merges."""
    path, seqs = reads
    g = _port_graph(path, p, canonical, chunk=chunk, max_runs=3)
    got = g.to_dict()
    _same_dict(got, _jax_graph(str(path), p, canonical)[1], False)
    assert got == oracle_debruijn(seqs, K, canonical=canonical)
    assert g.size() == len(got) and sum(g.local_sizes()) == len(got)
    if chunk == 211:
        assert g.timer.count("insert") > 15 and g.timer.count("merge")


@pytest.mark.parametrize("canonical", [True, False])
def test_graph_queries_match_jax(reads, canonical):
    """node_counts, edge_exists and neighbors of present, absent and
    reverse-complemented queries equal the JAX graph's."""
    path, _ = reads
    jg, want = _jax_graph(str(path), 4, canonical)
    g = _port_graph(path, 4, canonical, chunk=500)
    rng = np.random.default_rng(3)
    nodes = list(want)
    pick = [nodes[i] for i in rng.choice(len(nodes), 60, replace=False)]
    strs = [kt.DNA.decode(np.asarray(JSPEC.unpack_words(JSPEC.from_int(v)),
                                     np.uint8)) for v in pick]
    rc = ["".join({"A": "T", "C": "G", "G": "C", "T": "A"}[c]
                  for c in reversed(s)) for s in strs[:20]]
    absent = ["".join(rng.choice(list("ACGT"), K)) for _ in range(20)]
    q = strs + rc + absent
    gv, gf = g.node_counts(q)
    jv, jf = jg.node_counts(q)
    np.testing.assert_array_equal(gv, jv)
    np.testing.assert_array_equal(gf, jf)
    np.testing.assert_array_equal(g.edge_exists(q), jg.edge_exists(q))
    for s in strs[:12] + rc[:4] + absent[:2]:
        assert g.neighbors(s) == jg.neighbors(s)


@pytest.mark.parametrize("canonical,p", [(True, 4), (False, 1)])
def test_quality_graph_matches_jax(tmp_path, canonical, p):
    """The quality graph's counters, window counts and quality sums equal
    the JAX graph's and the float64 oracle's; node_quality likewise."""
    path, quals = tmp_path / "q.fastq", []
    seqs = _write_fastq(path, seed=82, quals=quals)
    jg, want = _jax_graph(str(path), p, canonical, quality=True)
    g = _port_graph(path, p, canonical, quality=True, chunk=300, max_runs=2)
    got = g.to_dict()
    _same_dict(got, want, True)
    base = oracle_debruijn(seqs, K, canonical=canonical)
    assert {k: v[:9] for k, v in got.items()} == base
    qsum = _quality_oracle(seqs, quals, canonical)
    np.testing.assert_allclose([got[k][10] for k in base],
                               [qsum[k] for k in base], rtol=1e-5)
    q = [kt.DNA.decode(np.asarray(JSPEC.unpack_words(JSPEC.from_int(v)),
                                  np.uint8)) for v in list(want)[:40]]
    q.append("C" * K)
    gm, gn, gf = g.node_quality(q)
    jm, jn, jf = jg.node_quality(q)
    assert gm.dtype == np.float32
    np.testing.assert_array_equal(gn, jn)
    np.testing.assert_array_equal(gf, jf)
    np.testing.assert_allclose(gm, jm, rtol=QRTOL)
    np.testing.assert_array_equal(g.node_counts(q)[0], jg.node_counts(q)[0])


@pytest.mark.parametrize("canonical,p", [(True, 4), (False, 1)])
def test_pre_encoded_batch_matches_jax(reads, canonical, p):
    """A batch already in the k-mer alphabet takes the lossy non-raw path
    ('N' neighbours read as 'A', not 0xF), as in the JAX package, and
    warns once."""
    path, _ = reads
    _, want = _jax_graph(str(path), p, canonical, encoded=True)
    g = kp.DeBruijnGraph(SPEC, device="cpu", nparts=p, canonical=canonical)
    batch = port_read_file(path, kp.DNA)
    with pytest.warns(RuntimeWarning, match="lossy"):
        g.insert_batch(batch, chunk_bases=400)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        g.insert_batch(port_read_file(path, kp.DNA).slice_bases(0, 0))
    assert g.to_dict() == want
    assert want != _jax_graph(str(path), p, canonical)[1]


def test_ingest_compact_ingest_merge(tmp_path):
    """File ingest, a compaction (the run becomes weighted), more ingest,
    then the merge of the weighted run with a unit one (K2 with the
    weights): the answers stay the oracle's.  Many duplicates make the
    consolidation compact by itself too."""
    a, b = tmp_path / "a.fastq", tmp_path / "b.fastq"
    sa = _write_fastq(a, seed=5, n_reads=300, genome_len=150)
    sb = _write_fastq(b, seed=6, n_reads=40, genome_len=150)
    for quality in (False, True):
        g = _port_graph(a, 2, True, quality=quality, chunk=2000)
        g.compact()
        assert g._unit == [False] and len(g.runs) == 1
        g.build(b)
        assert g._unit[0] is False and g._unit[1:] == [True] * (
            len(g.runs) - 1) and len(g.runs) > 1
        got = g.to_dict()
        assert len(g.runs) == 1 and g._unit == [False]
        assert {k: v[:9] for k, v in got.items()} == \
            oracle_debruijn(sa + sb, K)
        cap = g.capacity
        g2 = _port_graph(a, 2, True, quality=quality, chunk=2000)
        raw_cap = sum(r.capacity for r in g2.runs)
        g2.size()                       # consolidate: compacts on its own
        assert g2.capacity < raw_cap and g2._unit == [False]
        assert cap >= g2.capacity


def test_graph_npz_across_packages(reads, tmp_path):
    """Graph npz files ("debruijn" / "debruijn_quality") written by either
    package load in the other, at another shard count."""
    path, _ = reads
    for quality, jcls, pcls in ((False, JaxGraph, kp.DeBruijnGraph),
                                (True, JaxQGraph, kp.QualityDeBruijnGraph)):
        jg, want = _jax_graph(str(path), 4, True, quality=quality)
        jg.save(tmp_path / "jax.npz")
        for p in (1, 3):
            g = pcls.load(tmp_path / "jax.npz", "cpu", nparts=p)
            assert type(g) is pcls and g.nparts == p
            _same_dict(g.to_dict(), want, quality)
        g.save(tmp_path / "port.npz")
        back = jcls.load(tmp_path / "port.npz", mesh=make_mesh(2))
        _same_dict(back.to_dict(), want, quality)
        other = kp.QualityDeBruijnGraph if not quality else kp.DeBruijnGraph
        with pytest.raises(ValueError, match="index, not"):
            other.load(tmp_path / "port.npz", "cpu")


def test_debruijn_graph_from_state(reads):
    """A JAX graph's consolidated run carried across, weights and all."""
    path, _ = reads
    for quality in (False, True):
        jg, want = _jax_graph(str(path), 4, True, quality=quality)
        r = jg.runs[0]
        g = debruijn_graph_from_state(
            np.asarray(r.keys), np.asarray(r.ebytes), np.asarray(r.weights),
            np.asarray(r.qsums) if quality else None, spec=SPEC,
            device="cpu")
        assert g.nparts == 4 and isinstance(g, kp.QualityDeBruijnGraph) \
            == quality
        _same_dict(g.to_dict(), want, quality)


def test_index_config_builds_the_graph(reads):
    path, _ = reads
    cfg = dict(index="debruijn", devices=4, hash_name="farm", saturate=3)
    g = kp.IndexConfig(**cfg).make_index("cpu")
    assert type(g) is kp.DeBruijnGraph and g.nparts == 4
    assert g.hash_name == "farm" and g.saturate == 3 and g.canonical
    jg = JaxIndexConfig(**dict(cfg, devices=None)).make_index(make_mesh(4))
    g.build(path)
    jg.build(path)
    assert g.to_dict() == jg.to_dict()
    assert not kp.IndexConfig(index="debruijn",
                              strands="single").make_index("cpu").canonical
    for bad in ({"strands": "lex_greater"}, {"strands": "xor_rev_comp"},
                {"distribution": "range"}):
        with pytest.raises(ValueError):
            kp.IndexConfig(index="debruijn", **bad).make_index("cpu")
    with pytest.raises(ValueError, match="lex_less"):
        kp.DeBruijnGraph(SPEC, device="cpu", canonical="lex_greater")


@pytest.mark.parametrize("quality", [False, True])
@pytest.mark.parametrize("p", [1, 4])
def test_graph_checkpoint_round_trip(reads, tmp_path, quality, p):
    path, _ = reads
    g = _port_graph(path, p, True, quality=quality, chunk=600)
    want = g.to_dict()
    g.build(path)                        # a second, lazy run on top
    want2 = g.to_dict()
    save_index(g, tmp_path / "ckpt")
    back = load_index(tmp_path / "ckpt", "cpu")
    assert type(back) is type(g) and back.nparts == p
    _same_dict(back.to_dict(), want2, quality)
    assert {k: v[8] for k, v in want2.items()} == \
        {k: 2 * v[8] for k, v in want.items()}
    if quality:
        assert back.codec.name == g.codec.name


def test_reserve_clear_and_empty(reads):
    path, _ = reads
    g = _port_graph(path, 2, True, quality=True)
    want = g.to_dict()
    g.reserve(1 << 16)
    assert g.capacity >= (1 << 15)
    _same_dict(g.to_dict(), want, True)     # (a compaction regroups sums)
    g.clear()
    assert g.empty() and g.to_dict() == {}


# ---------------------------------------------------- the left halo readers
@pytest.mark.parametrize("halo_left", [0, 1, 3])
def test_iter_chunks_left_halo_matches_jax(reads, halo_left):
    path, _ = reads
    got = list(port_read_file(path, kp.ASCII).iter_chunks(500, K, halo_left))
    want = list(jax_read_file(path, kt.ASCII).iter_chunks(500, K, halo_left))
    assert len(got) == len(want) > 3
    for a, b in zip(got, want):
        assert_batches_equal(a, b)


def test_fasta_block_left_halo_and_stream_build(tmp_path):
    """read_fasta_block(halo_left=1) equals the JAX reader's block by
    block, and a graph streamed from many FASTA blocks (wrapped lines,
    records spanning blocks) equals the oracle."""
    from torch_parity import write_reads
    path = tmp_path / "reads.fasta"
    seqs = write_reads(path, 30, 150, 600, seed=9, fmt="fasta",
                       n_rate=0.02, line_width=37)
    n = 9
    for part in range(n):
        a = tfiles.read_fasta_block(path, kp.ASCII, part, n, halo=K,
                                    halo_left=1)
        b = jfiles.read_fasta_block(path, kt.ASCII, part, n, halo=K,
                                    halo_left=1)
        assert_batches_equal(a, b)
    g = kp.DeBruijnGraph(SPEC, device="cpu", nparts=2)
    g.build_stream(path, block_bytes=512)
    assert g.timer.count("read") > 5
    assert g.to_dict() == oracle_debruijn(seqs, K)
