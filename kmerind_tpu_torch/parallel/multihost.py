"""Multi-process deployment: ranks, their file blocks and their launcher.

The port of ``kmerind_tpu.parallel.multihost``.  The reference's process
model is ``mpirun`` + ``mxx::env``; the JAX package's is `jax.distributed`
and a global mesh; here it is `torch.distributed`, one process per rank.
Each rank:

1. calls `initialize()` (torchrun's environment, or explicit arguments);
2. takes the layout of the index's shards over all ranks (`global_mesh`);
3. reads only its own byte block of the input — the BlockPartitioner
   byte-range decomposition with FASTQ / FASTA record repair
   (file.hpp:1216-1432): `host_block_batch`, or the streamed grid of
   ``CountIndex.build_stream`` — and feeds it to the index, whose
   exchanges are collectives over the group.

The record context of a rank's first FASTA record (the reference's
distributed header scan, fasta_loader.hpp:202-360) and the number of
FASTQ records before a rank's range (so long position ids number the
records in the file, as a one-process build does) come from one small
all-gather of per-rank scan results.

`launch` starts W rank processes of a "module:function" target — the
tests, `dryrun_multichip` and the smoke run use it — each running
`_rank_main`.
One process without a group uses everything here as it is: `initialize()`
is then a no-op and every layout has world 1.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import importlib
import json
import os
import pathlib
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as tdist

from ..alphabets import Alphabet
from ..io.batch import ReadBatch
from ..io.fastq import parse_fastq_bytes
from ..io.files import (block_partition, fastq_block_span,
                        fasta_block_record_starts, file_size, read_bytes,
                        read_fasta_block, read_fastq_block, sniff_format)
from .mesh import Mesh, make_mesh

__all__ = ["initialize", "global_mesh", "host_block_batch",
           "distributed_fasta_context", "distributed_fasta_grid_context",
           "distributed_fastq_grid_base", "launch", "dryrun_multichip"]

_REPO = pathlib.Path(__file__).resolve().parents[2]
#: the rank process's program (not ``-m`` of this module, which the
#: package's own imports load first)
_RANK_MAIN = ("import sys; from kmerind_tpu_torch.parallel.multihost "
              "import _rank_main; _rank_main(sys.argv[1:])")


def initialize(init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None, backend: str = "nccl",
               timeout_s: float = 300.0) -> bool:
    """Join the process group (mxx::env analog).  Without arguments it reads
    torchrun's `WORLD_SIZE` / `RANK` / `MASTER_ADDR` (init "env://"), and
    without those it does nothing and returns False (one process).
    `backend` is the caller's: "nccl" for ranks on CUDA cards, "gloo" for
    ranks on the CPU or sharing one card (host-staged exchanges)."""
    if init_method is None:
        if not {"WORLD_SIZE", "RANK", "MASTER_ADDR"} <= set(os.environ):
            return False
        init_method = "env://"
    tdist.init_process_group(
        backend, init_method=init_method, world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    return True


def global_mesh(nparts: int | None = None, device="cuda") -> Mesh:
    """The 1-D layout of `nparts` shards (default one per rank) over every
    rank of the default group, this rank's on `device`."""
    return make_mesh(nparts, device)


def _ints(mesh: Mesh, *vals) -> np.ndarray:
    """int64[world, len(vals)]: every rank's host ints, in rank order."""
    return mesh.all_gather(torch.tensor([vals], dtype=torch.int64)).numpy()


def host_block_batch(path, alphabet: Alphabet, mesh: Mesh,
                     fmt: str | None = None, halo: int = 0, file_id: int = 0,
                     halo_left: int = 0) -> ReadBatch:
    """This rank's byte block of `path`, parsed with record repair — a
    collective.  Rank r of W owns the FASTQ records starting in byte block
    r (numbered in the file: one all-gather of the ranks' record counts)
    or the FASTA bases in block r plus `halo` following and `halo_left`
    preceding context bases (the record context from
    `distributed_fasta_context`).  A de Bruijn build passes the graph's
    `parse_alphabet` (raw ASCII) so its edges see the raw bytes."""
    fmt = fmt or sniff_format(path)
    r, w = mesh.rank, mesh.world
    if fmt == "fastq":
        b = read_fastq_block(path, alphabet, r, w, file_id=file_id)
        counts = _ints(mesh, b.num_records)[:, 0]
        return dataclasses.replace(
            b, seq_index=b.seq_index + np.int64(counts[:r].sum()).astype(
                b.seq_index.dtype))
    ctx = distributed_fasta_context(path, mesh) if w > 1 else None
    return read_fasta_block(path, alphabet, r, w, file_id=file_id,
                            halo=halo, halo_left=halo_left, context=ctx)


def distributed_fasta_context(path, mesh: Mesh) -> tuple[int, int]:
    """(ordinal, start position) of the FASTA record containing this rank's
    block start — (-1, -1) if no record starts at or before it — a
    collective.  Each rank scans only its own block for record-run starts;
    one all-gather of (count, last start) per rank gives the ordinal (the
    earlier ranks' counts) and the nearest earlier start."""
    h, nh = mesh.rank, mesh.world
    bs, be = block_partition(file_size(path), nh, h)
    local = fasta_block_record_starts(path, bs, be)
    g = _ints(mesh, local.size, int(local[-1]) if local.size else -1)
    counts, lasts = g[:, 0], g[:, 1]
    before = int(counts[:h].sum())
    if local.size and int(local[0]) == bs:
        return before, bs
    prev = lasts[:h][lasts[:h] >= 0]
    if prev.size == 0:
        return -1, -1
    return before - 1, int(prev[-1])


def distributed_fasta_grid_context(path, blocks_per_host: int,
                                   mesh: Mesh) -> list:
    """Per-sub-block (ordinal, record start) contexts of this rank's
    `blocks_per_host` sub-blocks of the `world * blocks_per_host` block
    grid of a streamed build — a collective.  Each rank scans its range
    one sub-block at a time (O(sub-block) memory), one all-gather of
    (count, last start) per rank gives the cross-rank prefix, and the
    local prefix walk gives each sub-block's context; (-1, -1) where no
    record starts at or before a sub-block."""
    h, nh = mesh.rank, mesh.world
    total = file_size(path)
    nblocks = nh * blocks_per_host
    counts = np.zeros(blocks_per_host, np.int64)
    firsts = np.full(blocks_per_host, -1, np.int64)
    lasts = np.full(blocks_per_host, -1, np.int64)
    bounds = []
    for j in range(blocks_per_host):
        bs, be = block_partition(total, nblocks, h * blocks_per_host + j)
        bounds.append(bs)
        local = fasta_block_record_starts(path, bs, be)
        counts[j] = local.size
        if local.size:
            firsts[j], lasts[j] = int(local[0]), int(local[-1])
    my_last = int(lasts[lasts >= 0][-1]) if (lasts >= 0).any() else -1
    g = _ints(mesh, int(counts.sum()), my_last)
    count_so_far = int(g[:h, 0].sum())
    prev = g[:h, 1][g[:h, 1] >= 0]
    last = int(prev[-1]) if prev.size else -1
    ctxs = []
    for j in range(blocks_per_host):
        bs = bounds[j]
        if firsts[j] == bs:
            ctxs.append((count_so_far, bs))
        elif count_so_far == 0:
            ctxs.append((-1, -1))
        else:
            ctxs.append((count_so_far - 1, last))
        count_so_far += int(counts[j])
        if lasts[j] >= 0:
            last = int(lasts[j])
    return ctxs


def distributed_fastq_grid_base(path, blocks_per_host: int,
                                mesh: Mesh) -> int:
    """The number of FASTQ records that start before this rank's range of
    the `world * blocks_per_host` block grid — a collective, the FASTQ
    analog of the grid scan: each rank counts the records of its range
    one sub-block at a time (their record table only, no base encoding),
    and one all-gather of the per-rank counts gives the prefix.  A
    streamed build numbers its records from it, so long position ids
    follow the file as in a one-process build."""
    h, nh = mesh.rank, mesh.world
    total = file_size(path)
    nblocks = nh * blocks_per_host
    mine = 0
    for j in range(blocks_per_host):
        first, nxt = fastq_block_span(path, block_partition(
            total, nblocks, h * blocks_per_host + j))
        if first < nxt:
            mine += parse_fastq_bytes(
                read_bytes(path, first, nxt))["record_start"].shape[0]
    return int(_ints(mesh, mine)[:h, 0].sum())


# ------------------------------------------------------------ the launcher
def launch(target: str, world: int, args=(), init_method: str | None = None,
           backend: str = "gloo", timeout_s: float = 120.0,
           pythonpath=(), env: dict | None = None) -> list[str]:
    """Run `target` ("module:function", called with the string `args`) in
    `world` rank processes of one group and return their standard outputs
    in rank order.  The ranks meet at `init_method` (default: a fresh
    ``file://`` store under TMPDIR, no port to race for), each in its own
    session; if a rank fails or any outlives `timeout_s`, every rank is
    killed and RuntimeError carries their outputs."""
    tmp = None
    if init_method is None:
        tmp = tempfile.mkdtemp(prefix="kmerind_rdzv_")
        init_method = "file://" + os.path.join(tmp, "store")
    penv = dict(os.environ if env is None else env)
    penv["PYTHONPATH"] = os.pathsep.join(
        [str(_REPO), *map(str, pythonpath)]
        + ([penv["PYTHONPATH"]] if penv.get("PYTHONPATH") else []))
    procs = []
    try:
        for r in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _RANK_MAIN, "--target", target,
                 "--rank", str(r), "--world", str(world), "--init-method",
                 init_method, "--backend", backend, "--timeout",
                 str(timeout_s), "--", *map(str, args)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=penv, start_new_session=True))
        return _wait_all(procs, time.monotonic() + timeout_s)
    finally:
        _kill(procs)
        if tmp is not None:
            for f in pathlib.Path(tmp).iterdir():
                f.unlink()
            os.rmdir(tmp)


def _kill(procs):
    for p in procs:
        if p.poll() is None:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
    for p in procs:
        p.wait()


def _wait_all(procs, deadline: float) -> list[str]:
    """Drain every rank's output until all exit; on the first failure or at
    the deadline kill them all and raise with what they printed."""
    import selectors
    sel = selectors.DefaultSelector()
    outs = [bytearray() for _ in procs]
    for i, p in enumerate(procs):
        sel.register(p.stdout, selectors.EVENT_READ, i)
    open_, failed = len(procs), None
    while open_ and failed is None:
        left = deadline - time.monotonic()
        if left <= 0:
            failed = "timed out"
            break
        for key, _ in sel.select(timeout=min(left, 1.0)):
            data = os.read(key.fileobj.fileno(), 1 << 16)
            if data:
                outs[key.data] += data
                continue
            sel.unregister(key.fileobj)
            open_ -= 1
            if procs[key.data].wait() != 0:
                failed = f"rank {key.data} exited {procs[key.data].returncode}"
    sel.close()
    text = [o.decode(errors="replace") for o in outs]
    if failed is not None:
        _kill(procs)
        raise RuntimeError(f"multi-process run failed: {failed}\n" + "\n".join(
            f"--- rank {i}:\n{t[-4000:]}" for i, t in enumerate(text)))
    return text


def _rank_main(argv=None):
    """One rank: join the group, run the target, leave the group."""
    ap = argparse.ArgumentParser(prog=__name__)
    ap.add_argument("--target", required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--init-method", required=True)
    ap.add_argument("--backend", required=True)
    ap.add_argument("--timeout", type=float, required=True)
    ap.add_argument("args", nargs="*")
    a = ap.parse_args(argv)
    initialize(a.init_method, a.world, a.rank, a.backend, a.timeout)
    try:
        mod, fn = a.target.split(":")
        getattr(importlib.import_module(mod), fn)(*a.args)
    finally:
        tdist.destroy_process_group()


# --------------------------------------------------------------- dry run
def _dryrun_rank(path: str, device: str):
    """One rank of `dryrun_multichip`: build a count index and a position
    index over all ranks, this rank's shard on `device`, from this rank's
    block of `path`; check both against the file, print one JSON line on
    rank 0."""
    from .. import DNA, CountIndex, KmerSpec, PositionIndex
    mesh = global_mesh(device=device)
    spec = KmerSpec(21, DNA)
    reads = pathlib.Path(path).read_text().split("\n")[1::4]
    n_windows = sum(max(0, len(s) - spec.k + 1) for s in reads)
    idx = CountIndex(spec, mesh=mesh, initial_capacity=1 << 10).build(path)
    assert sum(idx.to_dict().values()) == n_windows
    queries = [reads[0][i:i + spec.k] for i in range(8)]
    counts = idx.count(queries)
    assert counts.shape == (8,) and (counts >= 1).all(), counts
    pidx = PositionIndex(spec, mesh=mesh, initial_capacity=1 << 10)
    pidx.build(path)
    assert pidx.size() == n_windows
    ids, mask = pidx.find(queries[:2], max_per_query=4)
    assert mask[:, 0].all()
    size = idx.size()
    if mesh.rank == 0:
        print(json.dumps({"ranks": mesh.world, "size": size,
                          "windows": n_windows, "device": str(mesh.device),
                          "backend": mesh.backend}), flush=True)


def dryrun_multichip(n: int, device="cuda",
                     backend: str | None = None) -> dict:
    """One distributed build and query over `n` rank processes at a tiny
    size — the JAX package's ``__graft_entry__.dryrun_multichip``: a seeded
    8-read FASTQ, a `CountIndex` and a `PositionIndex` over `n` shards, one
    a rank, launched as the tests launch ranks.  Returns rank 0's summary.

    Each rank's shard lives on `device`: "cuda" is one card per rank
    (rank r on cuda:r), "cuda:i" puts every rank on card i, "cpu" runs on
    the host.  `backend` defaults to NCCL on CUDA and gloo on the CPU;
    ranks that share one card need ``backend="gloo"`` (NCCL refuses two
    ranks on one card), which stages the exchanges through host memory.
    On CUDA the kernels are built here, once, before the ranks start."""
    device = str(device)
    if backend is None:
        backend = "gloo" if torch.device(device).type == "cpu" else "nccl"
    if torch.device(device).type == "cuda":
        from ..ops import kernels
        kernels.build()
    rng = np.random.default_rng(7)
    reads = ["".join(rng.choice(list("ACGT"), size=60)) for _ in range(8)]
    with tempfile.TemporaryDirectory(prefix="kmerind_dryrun_") as d:
        path = os.path.join(d, "dryrun.fastq")
        with open(path, "w") as f:
            f.writelines(f"@r{i}\n{s}\n+\n{'I' * len(s)}\n"
                         for i, s in enumerate(reads))
        outs = launch(f"{__name__}:_dryrun_rank", n, (path, device),
                      backend=backend, timeout_s=300)
    return json.loads(outs[0].strip().splitlines()[-1])
