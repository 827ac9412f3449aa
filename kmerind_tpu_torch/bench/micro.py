"""Micro-benchmarks — the analog of the reference's perf binaries
(benchmark_kmer_ops / benchmark_bit_reverse / hash_vs_sort /
BenchmarkHashTables): each op's time and rate on one device, one JSON line
per op, each naming its device.

The port of ``kmerind_tpu.bench.micro``.  On a CUDA device the k-mer
extraction is K1's kernel (``extract_canonical_kernel``); with ``--device
cpu`` it is K1's plain version (``extract_canonical_plain``).  The local
point lookup is the bucket-seeded search of the count store
(``count_lookup_bucketed``); the JAX package's second lookup,
``count_lookup_join``, has no counterpart here — the port takes the
bucket-seeded search at every query count.  A device time is the best of
`--iters` CUDA-event intervals around one call; a CPU time, of host
clock intervals.

Usage: python -m kmerind_tpu_torch.bench.micro [--n 4194304] [--k 21]
           [--iters 3] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def _timer(device: torch.device):
    """fn -> seconds of one call: CUDA events on a card, else the host
    clock."""
    if device.type == "cuda":
        def run(fn):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
        return run

    def run(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    return run


def main(argv=None):
    ap = argparse.ArgumentParser(prog="kmerind_tpu_torch.bench.micro")
    ap.add_argument("--n", type=int, default=1 << 22)
    ap.add_argument("--k", type=int, default=21)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from .. import DNA, KmerSpec
    from ..index import store as st
    from ..io import native
    from ..ops import bitops, hashing, kernels, packing, sortops

    dev = torch.device(args.device)
    dname = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu")
    once = _timer(dev)
    n, spec = args.n, KmerSpec(args.k, DNA)
    rng = np.random.default_rng(0)
    codes = torch.from_numpy(rng.integers(0, 4, size=n).astype(
        np.uint8)).to(dev)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    results = []

    def emit(rec: dict):
        results.append(dict(rec, device=dname))
        print(json.dumps(results[-1]), flush=True)

    def bench(name, fn, items=n):
        fn()  # warm up: the first call builds kernels and caches
        best = min(once(fn) for _ in range(args.iters))
        emit({"op": name, "ms": round(best * 1e3, 4),
              "items_per_s": round(items / best, 0)})

    if dev.type == "cuda":
        bench("extract_canonical_kernel",
              lambda: kernels.extract_canonical(codes, spec))
    else:
        bench("extract_canonical_plain",
              lambda: packing.extract_canonical(codes, spec))
    words = packing.extract_kmers(codes, spec)
    bench("murmur3_32", lambda: hashing.murmur3_32(words))
    bench("sort_rows", lambda: sortops.sort_rows(
        words, (), valid, sentinel_ok=spec.sentinel_safe))

    def sort_unique():
        s, _, sv = sortops.sort_rows(words, (), valid,
                                     sentinel_ok=spec.sentinel_safe)
        return sortops.compact_runs(s, sv)
    bench("sort+unique_counts", sort_unique)
    bench("revcomp_packed", lambda: bitops.revcomp(words, spec))
    bench("reverse_packed", lambda: bitops.reverse(words, spec))

    # the local point lookup of the count store (the BenchmarkHashTables /
    # hash_vs_sort analog): one sorted unit run, bucket-seeded search
    kcols, _, svalid = sortops.sort_rows(words, (), valid, is_stable=False,
                                         sentinel_ok=spec.sentinel_safe,
                                         as_cols=True)
    ext, bstart = st.run_query_aux(st.run_from_sorted_unit(kcols, svalid))
    q = words[: max(1, n // 4)]
    bench("count_lookup_bucketed", lambda: st.run_lookup_aux(ext, bstart, q),
          items=q.shape[0])

    # the host parse rate — the BenchmarkFileLoader analog (the native
    # scanner on seeded FASTQ bytes, its buffer ring reused)
    if native.available():
        recs = []
        for i in range(max(1, n // 250)):
            seq = "".join(rng.choice(list("ACGT"), size=250))
            qual = "".join(chr(33 + int(x)) for x in rng.integers(0, 40, 250))
            recs.append(f"@r{i}\n{seq}\n+\n{qual}\n")
        data = np.frombuffer("".join(recs).encode(), np.uint8)
        native.fastq_parse(data, DNA, reuse=True)
        host = _timer(torch.device("cpu"))
        best = min(host(lambda: native.fastq_parse(data, DNA, reuse=True))
                   for _ in range(args.iters))
        emit({"op": "fastq_parse_native", "ms": round(best * 1e3, 4),
              "bytes_per_s": round(data.shape[0] / best, 0)})
    return results


if __name__ == "__main__":
    main()
