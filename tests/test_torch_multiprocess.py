"""The port's indexes over several processes (torch.distributed, gloo on
the CPU) against the JAX package's one-process build of the same file and
against the port's own one-process build at the same shard count — the
port's counterpart of tests/test_multiprocess.py, whose JAX runs read
fixtures outside the repository.

Every rank process comes from `parallel.multihost.launch` (tests/
torch_mp_worker.py): the ranks meet at a ``file://`` store under the
test's tmp directory, each reads only its own byte block of a seeded
input, and the launcher kills the whole group when a rank fails or
outlives its timeout, so a deadlock fails one test.  One launch runs
several index kinds: 2 ranks x 1 shard (every kind), 2 x 2 (1-D and the
2-D host-major layout) and 3 x 1 (a FASTA whose blocks start inside
records and header runs).

Contents are held exactly (quality sums at the parity rule: rtol 1e-3
plus 16 float32 ulps of the total); the shard sizes of the hash-owned
kinds equal the one-process build's, so owners do not depend on the
rank count.  The Bimolecule builds number their FASTQ records in the file
on every rank (one all-gather of the ranks' record counts, streamed or
not), so their stored orientations are the JAX package's whole-file ones;
the JAX streamed build numbers each block from 0 (ROADMAP queue 3), a
known divergence `test_bimolecule_streamed_block_numbering_known_
divergence` shows.
"""

import concurrent.futures
import functools
import json
import os

import numpy as np
import pytest
import torch

import kmerind_tpu as kt
from kmerind_tpu.debruijn import DeBruijnGraph as JGraph
from kmerind_tpu.debruijn import QualityDeBruijnGraph as JQGraph
from kmerind_tpu.index.api import BimoleculeCountIndex as JBimol
from kmerind_tpu.index.api import CountIndex as JCount
from kmerind_tpu.index.api import PositionIndex as JPosition
from kmerind_tpu.index.value_api import KmerValueIndex as JValue
from kmerind_tpu_torch.parallel.mesh import Mesh
from kmerind_tpu_torch.parallel.multihost import dryrun_multichip, launch

import torch_mp_worker as worker

HERE = os.path.dirname(os.path.abspath(__file__))
COMP = str.maketrans("ACGT", "TGCA")
JSPEC = kt.KmerSpec(21, kt.DNA)

#: (world, nparts, the kinds one launch builds): each launch well inside
#: its 120 s deadline on a loaded host
LAUNCHES = [
    (2, 2, ["count", "stream_count", "fasta_stream_count", "sorted_count",
            "position", "sorted_position"]),
    (2, 2, ["value_min", "sorted_value_max", "debruijn", "debruijn_quality",
            "bimol", "bimol_stream"]),
    (2, 4, ["count", "count2d"]),
    (3, 3, ["fasta_count"]),
]
CASES = [(w, p, k) for w, p, kinds in LAUNCHES for k in kinds]
CASE_IDS = [f"{k}-{w}x{p // w}" for w, p, k in CASES]
#: kinds whose owner is the hash of the key (the sorted indexes' ranges
#: come from samples of where the rows were before the flush)
HASHED = {k for _, _, k in CASES if not k.startswith("sorted")}


def write_fastq(path, rng, n_reads: int, genome_len: int):
    """150-bp reads of a random genome (half reverse-complemented, 'N' at
    rate 0.005, phred 2-40)."""
    genome = "".join(rng.choice(list("ACGT"), genome_len))
    with open(path, "w") as f:
        for i in range(n_reads):
            s = int(rng.integers(0, genome_len - 150))
            r = genome[s:s + 150]
            if rng.random() < 0.5:
                r = r.translate(COMP)[::-1]
            r = "".join("N" if rng.random() < 0.005 else c for c in r)
            q = "".join(chr(33 + int(x)) for x in rng.integers(2, 41, 150))
            f.write(f"@r{i}\n{r}\n+\n{q}\n")
    return genome


def write_inputs(d, seed: int = 3):
    """Seeded inputs: a FASTQ of 300 reads of a 6,000-base genome; a short
    FASTQ of 40 reads of an 800-base one (deep coverage: most keys recur,
    on both strands) for the builds cut into many tiny blocks; a FASTA of
    12 records of the first genome with ';' comment lines, two-line
    header runs and 70-column sequence lines."""
    rng = np.random.default_rng(seed)
    genome_len = 6000
    genome = write_fastq(d / "reads.fastq", rng, 300, genome_len)
    write_fastq(d / "small.fastq", rng, 40, 800)
    with open(d / "seqs.fasta", "w") as f:
        for i in range(12):
            n = int(rng.integers(200, 900))
            s = int(rng.integers(0, genome_len - n))
            if i % 3 == 0:
                f.write(f";comment {i}\n")
            f.write(f">s{i}\n")
            if i % 4 == 1:
                f.write(f">s{i} second header line\n")
            for j in range(0, n, 70):
                f.write(genome[s + j:s + min(j + 70, n)] + "\n")
    return {"fastq": d / "reads.fastq", "small": d / "small.fastq",
            "fasta": d / "seqs.fasta"}


def _launch_all(out, paths: dict) -> list:
    """Every launch of LAUNCHES, one after the other, each writing into
    out/<world>x<nparts>: the ranks' outputs of each."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    res = []
    for i, (w, p, kinds) in enumerate(LAUNCHES):
        d = out / f"{w}x{p}"
        d.mkdir(exist_ok=True)
        res.append(launch("torch_mp_worker:run", w,
                          [d, paths["fastq"], paths["small"],
                           paths["fasta"], p, ",".join(kinds)],
                          init_method=f"file://{out}/store_{i}",
                          timeout_s=120, pythonpath=[HERE], env=env))
    return res


def _jax_dict(kind: str, path) -> dict:
    """The JAX package's one-process build of `path` (the conftest's CPU
    mesh) as the worker's JSON contents."""
    make = {"count": lambda: JCount(JSPEC),
            "position": lambda: JPosition(JSPEC, id_kind="short"),
            "value_min": lambda: JValue(JSPEC, reduce="min",
                                        id_kind="short"),
            "value_max": lambda: JValue(JSPEC, reduce="max",
                                        id_kind="short"),
            "debruijn": lambda: JGraph(JSPEC),
            "debruijn_quality": lambda: JQGraph(JSPEC),
            "bimol": lambda: JBimol(JSPEC)}[kind]
    d = make().build(str(path)).to_dict()
    return {str(k): v if isinstance(v, int) else list(v)
            for k, v in d.items()}


#: the JAX build each kind is held against: (JAX kind, input)
JAX_OF = {"count": ("count", "fastq"), "count2d": ("count", "fastq"),
          "stream_count": ("count", "small"),
          "sorted_count": ("count", "fastq"),
          "fasta_count": ("count", "fasta"),
          "fasta_stream_count": ("count", "fasta"),
          "position": ("position", "fastq"),
          "sorted_position": ("position", "fastq"),
          "value_min": ("value_min", "fastq"),
          "sorted_value_max": ("value_max", "fastq"),
          "debruijn": ("debruijn", "fastq"),
          "debruijn_quality": ("debruijn_quality", "fastq"),
          "bimol": ("bimol", "small"), "bimol_stream": ("bimol", "small")}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Launch the rank groups in a thread while the JAX references build
    here; returns (results {(world, nparts, kind): JSON}, JAX contents
    {(JAX kind, input): dict}, the inputs)."""
    d = tmp_path_factory.mktemp("mp")
    paths = write_inputs(d)
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        fut = ex.submit(_launch_all, d, paths)
        want = {key: _jax_dict(key[0], paths[key[1]])
                for key in set(JAX_OF.values())}
        outs = fut.result()
    got = {(w, p, k): json.loads((d / f"{w}x{p}" / f"{k}.json").read_text())
           for w, p, k in CASES}
    for (w, _, _), o in zip(LAUNCHES, outs):
        assert len(o) == w and all("ok" in x for x in o)
    return got, want, paths


def _assert_quality_close(got: dict, want: dict):
    """Counters and window counts exact; quality sums at rtol 1e-3 plus 16
    float32 ulps of the run's quality total."""
    assert got.keys() == want.keys()
    total = sum(v[10] for v in want.values())
    slack = 16 * float(np.spacing(np.float32(total)))
    for k, w in want.items():
        assert got[k][:10] == w[:10], k
        assert abs(got[k][10] - w[10]) <= 1e-3 * abs(w[10]) + slack, k


@pytest.mark.parametrize("world,nparts,kind", CASES, ids=CASE_IDS)
def test_contents_equal_the_jax_one_process_build(runs, world, nparts, kind):
    got, want, _ = runs
    res, ref = got[world, nparts, kind], want[JAX_OF[kind]]
    assert res["world"] == world
    if kind == "count2d":
        assert res["shape"] == [world, nparts // world]
    if kind == "debruijn_quality":
        _assert_quality_close(res["contents"], ref)
    elif kind.endswith("position"):
        assert res["contents"] == {k: sorted(v) for k, v in ref.items()}
    else:
        assert res["contents"] == ref
    pairs = sum(len(v) for v in ref.values()) \
        if kind.endswith("position") else len(ref)
    assert res["size"] == pairs == sum(res["local_sizes"])


@functools.lru_cache(maxsize=None)
def _port_one_process(kind: str, nparts: int, path: str):
    """The port's one-process build at the same shard count: (local_sizes,
    size)."""
    make, _, how = worker.KINDS[kind]
    idx = make(Mesh(nparts, torch.device("cpu")), None)
    if how == "stream":
        idx.build_stream(path, block_bytes=worker.BLOCK_BYTES)
    else:
        idx.build(path)
    return idx.local_sizes(), idx.size()


@pytest.mark.parametrize("world,nparts,kind", CASES, ids=CASE_IDS)
def test_shards_equal_the_port_one_process_build(runs, world, nparts, kind):
    got, _, paths = runs
    res = got[world, nparts, kind]
    sizes, size = _port_one_process(kind, nparts,
                                    str(paths[worker.KINDS[kind][1]]))
    assert res["size"] == size and len(res["local_sizes"]) == nparts
    if kind in HASHED:
        assert res["local_sizes"] == sizes
    else:
        assert sum(res["local_sizes"]) == sum(sizes)


@pytest.mark.parametrize("world,nparts,kind", CASES, ids=CASE_IDS)
def test_query_round_trip_and_cross_host_stats(runs, world, nparts, kind):
    got, _, _ = runs
    res = got[world, nparts, kind]
    assert len(res["queried"]) == 16
    c = res["contents"]
    want = {"position": len, "sorted_position": len,
            "value_min": lambda v: v, "sorted_value_max": lambda v: v,
            "debruijn": lambda v: v[8], "debruijn_quality": lambda v: v[8]
            }.get(kind, lambda v: v)
    assert res["answers"] == [want(c[q]) for q in res["queried"]]
    assert res["timer_count_ok"] and "insert" in res["timer_phases"]


@pytest.mark.parametrize("kind", sorted(worker.PERSIST))
def test_checkpoint_and_npz_reload_over_the_ranks(runs, kind):
    """save_index writes each rank's shards, npz save is rank 0's: both
    reload over the same 2 ranks to the contents built."""
    got, _, _ = runs
    assert got[2, 2, kind]["reloaded"] is True


def test_bimolecule_streamed_block_numbering_known_divergence(runs):
    """The JAX streamed FASTQ build numbers each block's records from 0
    (ROADMAP queue 3), so a key first seen after a block boundary can keep
    a later occurrence's orientation; the port's ranks number records in
    the file, and keep the whole-file build's orientations (checked above
    against the JAX whole-file build)."""
    got, want, paths = runs
    # blocks of ~6 records: a later record of a block outranks the first
    # record of the next (within-block numbers lead the 64-bit id)
    jax_stream = JBimol(JSPEC).build_stream(
        str(paths["small"]), block_bytes=2000).to_dict()
    stream = {str(k): v for k, v in jax_stream.items()}
    whole = want["bimol", "small"]
    port = got[2, 2, "bimol_stream"]["contents"]
    assert port == whole
    # the same canonical keys and counts either way; only orientations move
    canon = lambda d: sorted(d.values())  # noqa: E731
    assert canon(stream) == canon(whole) and len(stream) == len(whole)
    assert stream != whole


def test_dryrun_multichip():
    out = dryrun_multichip(2, device="cpu")
    assert out["ranks"] == 2 and out["windows"] == 8 * (60 - 21 + 1)
    assert out["device"] == "cpu" and out["backend"] == "gloo"
    assert 0 < out["size"] <= out["windows"]


def test_a_failed_rank_fails_the_launch(tmp_path):
    """Rank 1 raises while rank 0 waits in a collective: the launch kills
    the group and raises at once, with the failing rank's output."""
    with pytest.raises(RuntimeError, match="fails on purpose"):
        launch("torch_mp_worker:fail_one", 2, [], pythonpath=[HERE],
               init_method=f"file://{tmp_path}/store", timeout_s=60)


def test_a_hung_rank_is_killed_at_the_timeout(tmp_path):
    with pytest.raises(RuntimeError, match="timed out"):
        launch("torch_mp_worker:hang", 2, [], pythonpath=[HERE],
               init_method=f"file://{tmp_path}/store", timeout_s=10)


@pytest.mark.parametrize("capacity", [32, 8], ids=["fits", "overflows"])
def test_exchange_over_ranks_equals_one_process(tmp_path, capacity):
    """2 ranks x 2 shards: each destination shard receives exactly the
    buckets one process routing all 4 shards gives it, replies come back
    to their rows, and both see the same (global) overflow."""
    from kmerind_tpu_torch.parallel import distribute as dist
    launch("torch_mp_worker:exchange", 2, [tmp_path, 4, capacity],
           pythonpath=[HERE], init_method=f"file://{tmp_path}/store",
           timeout_s=60, env=dict(os.environ, OMP_NUM_THREADS="1"))
    x, owner, valid = worker.exchange_inputs(4)
    (rx,), rvalid, route = dist.distribute((x,), owner, valid, 4, capacity)
    (back,) = dist.undistribute((rx * 2,), route, 4, capacity, fill=-7)
    for r in range(2):
        got = torch.load(tmp_path / f"exchange_{r}.pt")
        assert torch.equal(got["recv"], rx[2 * r:2 * r + 2])
        assert torch.equal(got["rvalid"], rvalid[2 * r:2 * r + 2])
        assert torch.equal(got["back"], back[2 * r:2 * r + 2])
        assert got["overflow"] == route.overflow
    assert (route.overflow > 0) == (capacity == 8)
