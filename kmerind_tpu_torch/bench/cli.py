"""Benchmark CLI — the BenchmarkKmerIndex equivalent.

The port of ``kmerind_tpu.bench.cli``, a rebuild of the reference's
application driver (test/benchmark/BenchmarkKmerIndex.cpp): read a query
sample, build the configured index from a FASTQ/FASTA file (or restore a
checkpoint), then run count / find / erase over the queries, reporting
per-phase timings in the ``[TIME]`` format.  Every knob of the
reference's compile-time matrix (:45-260) is a runtime flag.

One process, on one card or the CPU::

  python -m kmerind_tpu_torch.bench.cli -F reads.fastq [-Q query.fastq]
      [--index count|position|posqual|debruijn] [-k 21] [--alphabet DNA]
      [--single-strand | --bimolecule] [--map hash|sorted] [--hash murmur]
      [-S 100] [--device cuda] [--nparts N] [--save DIR | --load DIR]
      [--json]

Several ranks, one per card (torchrun's environment; the collective
backend is NCCL with a CUDA `--device`, gloo with `--device cpu`)::

  torchrun --nproc-per-node 4 -m kmerind_tpu_torch.bench.cli -F reads.fastq

Under torchrun each rank joins the group (`parallel.multihost.initialize`),
parses only its own byte block of the input and holds `--nparts` / W
shards (default one); every rank reads the whole query file, and rank 0
prints the reports, the phase statistics taken over the ranks.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

#: index class -> --index name of a restored checkpoint
_KIND = {"CountIndex": "count", "BimoleculeCountIndex": "count",
         "SortedCountIndex": "count", "PositionIndex": "position",
         "SortedPositionIndex": "position",
         "PositionQualityIndex": "posqual",
         "SortedPositionQualityIndex": "posqual",
         "KmerValueIndex": "value", "SortedKmerValueIndex": "value",
         "DeBruijnGraph": "debruijn", "QualityDeBruijnGraph": "debruijn"}


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="kmerind_tpu_torch.bench.cli",
        description="Build and query a distributed k-mer index "
                    "(BenchmarkKmerIndex equivalent)")
    ap.add_argument("-F", "--file", default=None, help="input FASTQ/FASTA "
                    "(required unless --load restores a built index)")
    ap.add_argument("-Q", "--query", default=None,
                    help="query file (defaults to the input file)")
    ap.add_argument("--index", default="count",
                    choices=["count", "position", "posqual", "debruijn"])
    ap.add_argument("-k", type=int, default=21)
    ap.add_argument("--alphabet", default="DNA")
    ap.add_argument("--single-strand", action="store_true",
                    help="disable canonicalization (SingleStrand preset)")
    ap.add_argument("--bimolecule", action="store_true",
                    help="Bimolecule preset: store input-strand keys, "
                         "hash/compare canonically (count index only)")
    ap.add_argument("--map", default="hash", choices=["hash", "sorted"],
                    help="distribution strategy: hash-partitioned "
                         "(densehash analog) or range-partitioned "
                         "(sorted_map analog, the reference's pMAP=SORTED)")
    ap.add_argument("--hash", default="murmur",
                    choices=["murmur", "farm", "fmix32", "std", "identity"])
    ap.add_argument("-S", "--sample", "--query-sample", type=float,
                    default=1.0,
                    help="query sampling: values >= 2 are the reference's "
                         "'one in N' ratio (BenchmarkKmerIndex.cpp:454-457 "
                         "keeps size/N shuffled kmers; its default is 100), "
                         "values in (0,1) a fraction; 1 keeps all queries")
    ap.add_argument("-A", "--algo", type=int, default=7,
                    help="reader algorithm id, accepted for drop-in "
                         "compatibility (reference: 2=loader, 5=mmap, "
                         "7=posix, 10=mpiio); one memory-mapped reader "
                         "serves all here")
    ap.add_argument("--device", default="cuda",
                    help="device of the index: 'cuda' (this rank's card), "
                         "'cuda:i' or 'cpu'")
    ap.add_argument("--nparts", type=int, default=None,
                    help="shards of the index over all ranks (default: one "
                         "per rank; with --load, the checkpoint's)")
    ap.add_argument("--format", default=None, choices=["fastq", "fasta"])
    ap.add_argument("--save", default=None, metavar="DIR",
                    help="after building, write a sharded checkpoint of the "
                         "index under DIR (utils.checkpoint)")
    ap.add_argument("--load", default=None, metavar="DIR",
                    help="restore the index from a --save checkpoint "
                         "instead of building; index-config flags are taken "
                         "from the checkpoint, -F becomes optional")
    ap.add_argument("--no-erase", action="store_true")
    ap.add_argument("--json", action="store_true",
                    help="emit a summary JSON line")
    return ap


def query_words(path, spec, fmt, device) -> np.ndarray:
    """uint32[m, w] rows of every k-mer window of the query file, as read
    (not canonicalized; the index transforms its queries)."""
    from ..io import read_file
    from ..io.kmer_parsers import DeviceBases, extract_tuples
    from ..ops.keys import to_numpy_u32
    b = read_file(path, spec.alphabet, fmt)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    tup = extract_tuples(DeviceBases(put(b.codes), put(b.valid),
                                     put(b.owned), put(b.seg_id)),
                         spec, canonical=False)
    return to_numpy_u32(tup.words)[tup.valid.cpu().numpy()]


def main(argv=None):
    ap = build_argparser()
    args = ap.parse_args(argv)
    if args.file is None and args.load is None:
        ap.error("-F/--file is required unless --load is given")
    if args.file is None and args.query is None:
        ap.error("--load without -F needs -Q/--query for the query kmers")

    from ..config import IndexConfig
    from ..kmer import KmerSpec
    from ..parallel.mesh import make_mesh
    from ..parallel.multihost import initialize
    from ..utils.timers import MemUsage, PhaseTimer
    from .. import alphabets

    initialize(backend="gloo" if args.device == "cpu" else "nccl")
    nparts = args.nparts
    if args.load is not None and nparts is None:
        from ..utils.checkpoint import saved_nparts
        nparts = saved_nparts(args.load)
    mesh = make_mesh(nparts, args.device)
    say = (lambda *a: print(*a, file=sys.stderr)) if mesh.rank == 0 \
        else (lambda *a: None)
    spec = KmerSpec(args.k, alphabets.by_name(args.alphabet))
    timer = PhaseTimer()
    mem = MemUsage()
    mem.mark("start")

    id_kind = "short"
    if args.format == "fasta" or str(args.file).endswith(
            (".fasta", ".fa", ".fna")):
        id_kind = "long"
    strands = ("bimolecule" if args.bimolecule
               else "single" if args.single_strand else "canonical")
    cfg = IndexConfig(
        k=args.k, alphabet=args.alphabet, index=args.index, strands=strands,
        distribution="range" if args.map == "sorted" else "hash",
        hash_name=args.hash, id_kind=id_kind, fmt=args.format)

    # ---- build (or restore a checkpoint, --load)
    t0 = time.perf_counter()
    if args.load is not None:
        from ..utils.checkpoint import load_index
        idx = load_index(args.load, mesh=mesh)
        idx.timer = timer
        # queries and reporting follow the CHECKPOINT's configuration
        spec = idx.spec
        args.index = _KIND[type(idx).__name__]
        verb = "restored"
    else:
        idx = cfg.make_index(mesh=mesh, timer=timer)
        idx.build(args.file, fmt=args.format)
        verb = "built"
    build_s = time.perf_counter() - t0
    mem.mark("after_build")
    size = idx.size()
    say(f"index {verb}: {size} entries in {build_s:.3f}s")
    if args.save is not None:
        from ..utils.checkpoint import save_index
        with timer.phase("save"):
            save_index(idx, args.save)
        say(f"checkpoint saved to {args.save}")

    # ---- the query sample (readForQuery + sample, BenchmarkKmerIndex
    # :486-497): every k-mer of the query file, then sampled
    with timer.phase("read_query"):
        qwords = query_words(args.query or args.file, spec, args.format,
                             idx.device)
    if args.sample >= 2:
        # the reference's -S: shuffle, keep size/N (sample(),
        # BenchmarkKmerIndex.cpp:373-392 via :497)
        take = max(1, len(qwords) // int(args.sample))
        rng = np.random.default_rng(0)
        qwords = qwords[rng.permutation(len(qwords))[:take]]
    elif args.sample < 1.0:
        rng = np.random.default_rng(0)
        take = max(1, int(len(qwords) * args.sample))
        qwords = qwords[rng.choice(len(qwords), size=take, replace=False)]
    say(f"queries: {len(qwords)} kmers")

    # ---- queries
    results = {"size": size, "build_s": round(build_s, 4)}
    if args.index in ("count", "position", "posqual"):
        with timer.phase("query_count"):
            counts = idx.count(qwords)
        results["count_hits"] = int((counts > 0).sum())
        results["count_total"] = int(counts.sum())
    if args.index in ("position", "posqual"):
        with timer.phase("query_find"):
            found = idx.find(qwords[: min(len(qwords), 4096)],
                             max_per_query=64)
        results["find_pairs"] = int(found[-1].sum())
    if args.index == "debruijn":
        with timer.phase("query_nodes"):
            _, found = idx.node_counts(qwords)
        results["nodes_found"] = int(found.sum())
    if args.index == "count" and not args.no_erase:
        with timer.phase("erase"):
            results["erased"] = idx.erase(qwords)

    mem.mark("end")
    title = f"{args.index}_k{args.k}"
    report = timer.report(title, cross_host=mesh.world > 1)
    say(report)
    say(mem.report(title))
    if args.json and mesh.rank == 0:
        print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
