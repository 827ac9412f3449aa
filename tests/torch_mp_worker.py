"""One rank of the port's multi-process tests (tests/test_torch_multiprocess.py),
the analog of tests/multiproc_worker.py for the JAX package.

`parallel.multihost.launch` starts W of these in one gloo group on the
CPU.  Each rank builds every index kind it is given over the global layout
of `nparts` shards from its own byte block of the input, then the ranks
query it together; rank 0 writes one JSON file per kind: the contents
(`to_dict`), the size, the per-shard sizes, 16 queries and their answers,
whether `cross_host_stats` saw every rank in every phase and, for the
kinds in `PERSIST`, whether the index's checkpoint and npz file reload
over the ranks to the same contents.

Usage (through `launch`): run(out_dir, fastq, small, fasta, nparts,
kinds) with kinds a comma-separated list of the names in `KINDS`; `small`
is a short FASTQ the streamed kinds cut into many tiny blocks.
"""

import json
import pathlib
import time

import numpy as np
import torch

import kmerind_tpu_torch as kp
from kmerind_tpu_torch.parallel.mesh import make_mesh, make_mesh_2d
from kmerind_tpu_torch.utils.timers import PhaseTimer

SPEC = kp.KmerSpec(21, kp.DNA)

#: kind -> (index factory (mesh, timer), input, how it builds)
KINDS = {
    "count": (lambda m, t: kp.CountIndex(SPEC, mesh=m, timer=t),
              "fastq", "build"),
    "count2d": (lambda m, t: kp.CountIndex(SPEC, mesh=m, timer=t),
                "fastq", "build"),
    "fasta_count": (lambda m, t: kp.CountIndex(SPEC, mesh=m, timer=t),
                    "fasta", "build"),
    "stream_count": (lambda m, t: kp.CountIndex(SPEC, mesh=m, timer=t),
                     "small", "stream"),
    "fasta_stream_count": (lambda m, t: kp.CountIndex(SPEC, mesh=m, timer=t),
                           "fasta", "stream"),
    "sorted_count": (lambda m, t: kp.SortedCountIndex(SPEC, mesh=m, timer=t),
                     "fastq", "build"),
    "position": (lambda m, t: kp.PositionIndex(SPEC, mesh=m, timer=t,
                                               id_kind="short"),
                 "fastq", "build"),
    "sorted_position": (lambda m, t: kp.SortedPositionIndex(
        SPEC, mesh=m, timer=t, id_kind="short"), "fastq", "build"),
    "value_min": (lambda m, t: kp.KmerValueIndex(SPEC, mesh=m, timer=t,
                                                 reduce="min",
                                                 id_kind="short"),
                  "fastq", "build"),
    "sorted_value_max": (lambda m, t: kp.SortedKmerValueIndex(
        SPEC, mesh=m, timer=t, reduce="max", id_kind="short"),
        "fastq", "build"),
    "debruijn": (lambda m, t: kp.DeBruijnGraph(SPEC, mesh=m, timer=t),
                 "fastq", "build"),
    "debruijn_quality": (lambda m, t: kp.QualityDeBruijnGraph(
        SPEC, mesh=m, timer=t), "fastq", "build"),
    "bimol": (lambda m, t: kp.BimoleculeCountIndex(SPEC, mesh=m, timer=t),
              "small", "build"),
    "bimol_stream": (lambda m, t: kp.BimoleculeCountIndex(SPEC, mesh=m,
                                                          timer=t),
                     "small", "stream"),
}

#: byte blocks of the streamed kinds: many per rank, some holding no
#: record start (a FASTQ record is ~320 bytes) or only header lines, so
#: the ranks' chunk counts differ
BLOCK_BYTES = 200


def answers(idx, kind: str, qwords: np.ndarray) -> list:
    """The index's answers to the query rows, as JSON values."""
    if kind.startswith("debruijn"):
        vals, found = idx.node_counts(qwords)
        return [int(c) for c in np.where(found, vals[:, 8], 0)]
    if kind in ("value_min", "sorted_value_max"):
        vals, found = idx.find(qwords)
        return [int(v) if f else None for v, f in zip(vals, found)]
    return [int(c) for c in idx.count(qwords)]


#: kinds whose npz file and checkpoint are reloaded over the ranks
PERSIST = {"count", "sorted_count", "position", "value_min", "debruijn",
           "bimol"}


def reloads_equal(idx, kind: str, contents: dict, out_dir: str) -> bool:
    """Each rank writes its own shards' checkpoint files (rank 0 the npz
    and the meta file); both reload over the same ranks to the same
    contents."""
    from kmerind_tpu_torch.utils.checkpoint import load_index, save_index
    d = pathlib.Path(out_dir)
    save_index(idx, d / f"{kind}_ck")
    ck = load_index(d / f"{kind}_ck", mesh=idx.mesh).to_dict()
    idx.save(d / f"{kind}.npz")
    npz = type(idx).load(d / f"{kind}.npz", mesh=idx.mesh).to_dict()
    return ck == contents and npz == contents


def run(out_dir: str, fastq: str, small: str, fasta: str, nparts: str,
        kinds: str):
    paths = {"fastq": fastq, "small": small, "fasta": fasta}
    for kind in kinds.split(","):
        mesh = (make_mesh_2d(nparts=int(nparts), device="cpu")
                if kind == "count2d" else make_mesh(int(nparts), "cpu"))
        make, src, how = KINDS[kind]
        timer = PhaseTimer()
        idx = make(mesh, timer)
        if how == "stream":
            idx.build_stream(paths[src], block_bytes=BLOCK_BYTES)
        else:
            idx.build(paths[src])
        size = idx.size()
        contents = idx.to_dict()
        some = sorted(contents)[:16]
        qwords = np.stack([SPEC.from_int(v) for v in some])
        counts = answers(idx, kind, qwords)
        stats = timer.cross_host_stats()
        local_sizes = [int(x) for x in idx.local_sizes()]
        reloaded = (reloads_equal(idx, kind, contents, out_dir)
                    if kind in PERSIST else None)
        if mesh.rank == 0:
            out = {
                "world": mesh.world, "shape": list(mesh.shape), "size": size,
                "local_sizes": local_sizes,
                "contents": {str(k): v if isinstance(v, (int, list))
                             else list(v) for k, v in contents.items()},
                "queried": [str(v) for v in some], "answers": counts,
                "timer_phases": sorted(stats),
                "timer_count_ok": all(s["count"] == mesh.world
                                      for s in stats.values()),
                "reloaded": reloaded,
            }
            (pathlib.Path(out_dir) / f"{kind}.json").write_text(
                json.dumps(out))
        print(f"rank {mesh.rank}: {kind} ok, size {size}", flush=True)


def fail_one():
    """Rank 1 fails while rank 0 waits for it in a collective."""
    mesh = make_mesh(2, "cpu")
    if mesh.rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    mesh.all_max(1)


def hang():
    """Every rank waits for good (the launcher's timeout must end it)."""
    make_mesh(2, "cpu").barrier()
    torch.distributed.barrier()
    time.sleep(3600)


def exchange_inputs(nparts: int, n: int = 50, seed: int = 4):
    """Seeded [nparts, n] values, owners and validity of every shard."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(-1000, 1000, (nparts, n, 3), generator=g)
    owner = torch.randint(0, nparts, (nparts, n), generator=g)
    valid = torch.rand((nparts, n), generator=g) < 0.8
    return x, owner, valid


def exchange(out_dir: str, nparts: str, capacity: str):
    """`distribute` and `undistribute` over the ranks: each rank routes its
    own shards' rows of `exchange_inputs` and saves what its shards
    received and what came back (rank r: exchange_<r>.pt)."""
    from kmerind_tpu_torch.parallel import distribute as dist
    mesh = make_mesh(int(nparts), "cpu")
    lo, hi = mesh.shard_range
    x, owner, valid = (t[lo:hi] for t in exchange_inputs(int(nparts)))
    cap = int(capacity)
    (rx,), rvalid, route = dist.distribute((x,), owner, valid, mesh, cap)
    (back,) = dist.undistribute((rx * 2,), route, mesh, cap, fill=-7)
    torch.save({"recv": rx, "rvalid": rvalid, "back": back,
                "overflow": route.overflow},
               pathlib.Path(out_dir) / f"exchange_{mesh.rank}.pt")
