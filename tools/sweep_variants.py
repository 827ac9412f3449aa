#!/usr/bin/env python3
"""Time design variants of the port's CUDA kernels on one GPU.

    python3 tools/sweep_variants.py [--kernel extract|merge|scan|runlength|all]
                                    [--variant NAME ...] [--rounds 2]

A variant is a committed source of kmerind_tpu_torch/ops/csrc with a few
text substitutions (`VARIANTS`: tile shape, per-thread work, ordering of the
look-back's status stores, cache hints, load path); "committed" is the
source as it is.  `--variant` keeps only the named variants.  All variants
are compiled at once (one nvcc each, sm_90a, the package's flags) and
linked with the other committed sources into one library each under
kmerind_tpu_torch/_build/variants.  In turn, each library is bound in place
of the package's and called through the port's own wrapper
(kernels.extract_canonical / merge_runs_cols / prefix_sum_i32 /
run_length_weights) at chip_smoke.py P2's shapes: checked bitwise against
the plain version, then timed with CUDA events over many launches
(chip_smoke.median_ms); in the first round also under torch.profiler, for
each CUDA kernel's mean device time per call (chip_smoke.kernel_us_per_call:
a kernel's own launches, without the gaps between them).  Beside them, in
the same rounds: the library yardstick of P2 (a stable torch.sort of the
runs' packed int64 keys; torch.cumsum) and, for the scan, a device copy of
the same bytes.  The rounds alternate over the variants, so drift shows as
a spread.  Prints one line per variant and case, each with the card's name
and power limit, then one JSON object of all the times.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import (CHUNK, GENOME_LEN, K, READ_LEN,  # noqa: E402
                        bound_ms, kernel_bytes, make_reads)

_LDCS = ("buf[swz(c)] = __ldcs(x4 + c);", "buf[swz(c)] = x4[c];")
_STCS = ("__stcs(o4 + c, buf[swz(c)]);", "o4[c] = buf[swz(c)];")

_WIDE_LOOP = """    const uint32_t* str = use_rc ? rev : fwd;
    const int p0 = use_rc ? r0 : j;
    for (int w = 0; w < nwords; ++w) {
      const int nb = w < nwords - 1 ? full_bits : last_bits;
      words[static_cast<int64_t>(w) * n + i] =
          stream_field(str, p0 + w * cpw, bits, nb);
    }
    was_rc[i] = use_rc;
  }"""
_WIDE_LOOP_WORD_MAJOR = """    p0s[s] = use_rc ? r0 : j;
    rcs[s] = use_rc;
    was_rc[i] = use_rc;
  }
  for (int w = 0; w < nwords; ++w) {
    const int nb = w < nwords - 1 ? full_bits : last_bits;
#pragma unroll
    for (int s = 0; s < kWideItems; ++s) {
      const int64_t i = g0 + s * kWideThreads + tid;
      if (i < n)
        words[static_cast<int64_t>(w) * n + i] =
            stream_field(rcs[s] ? rev : fwd, p0s[s] + w * cpw, bits, nb);
    }
  }"""
_WIDE_DECLS = ("  for (int s = 0; s < kWideItems; ++s) {\n"
               "    const int j = s * kWideThreads + tid;")

#: kernel -> (source, {variant: [(committed text, variant text), ...]})
VARIANTS = {
    "scan": ("prefix_sum.cu", {
        "committed": [],
        "release_store": [("st.relaxed.gpu", "st.release.gpu")],
        "tile_4096": [("kItems = 32;", "kItems = 16;")],
        "no_cache_hints": [_LDCS, _STCS],
        "tile_4096_release_no_hints": [
            ("kItems = 32;", "kItems = 16;"),
            ("st.relaxed.gpu", "st.release.gpu"), _LDCS, _STCS],
        "threads_128": [("kThreads = 256;", "kThreads = 128;")],
    }),
    "extract": ("extract_canonical.cu", {
        "committed": [],
        "items_8": [("kItems = 16;", "kItems = 8;")],
        "items_20": [("kItems = 16;", "kItems = 20;")],
        "items_32": [("kItems = 16;", "kItems = 32;")],
        "threads_256": [("kThreads = 128;", "kThreads = 256;")],
        "threads_512": [("kThreads = 128;", "kThreads = 512;")],
        "cache_hints": [
            ("*dst = __ldg(aligned + (g0 / 16 + m));",
             "*dst = __ldcs(aligned + (g0 / 16 + m));"),
            ("reinterpret_cast<uint4*>(col)[c] = sc[swz(c)];",
             "__stcs(reinterpret_cast<uint4*>(col) + c, sc[swz(c)]);")],
        "cp_async": [
            ("*dst = __ldg(aligned + (g0 / 16 + m));",
             'asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" '
             ':: "r"(static_cast<unsigned>(__cvta_generic_to_shared(dst))),'
             ' "l"(aligned + (g0 / 16 + m)) : "memory");'),
            ("  __syncthreads();\n\n  // roll in the warm-up codes",
             '  asm volatile("cp.async.wait_all;" ::: "memory");\n'
             "  __syncthreads();\n\n  // roll in the warm-up codes")],
        # the wide (bit-stream) kernel's tile shape
        "wide_items_8": [("kWideItems = 4;", "kWideItems = 8;")],
        "wide_items_16": [("kWideItems = 4;", "kWideItems = 16;")],
        "wide_threads_128": [("kWideThreads = 256;", "kWideThreads = 128;")],
        # each window's words stored as soon as its strand is decided
        # (window by window, not word column by word column)
        "wide_window_major": [
            ("  int p0s[kWideItems];\n  bool rcs[kWideItems];\n"
             + _WIDE_DECLS, _WIDE_DECLS),
            (_WIDE_LOOP_WORD_MAJOR, _WIDE_LOOP)],
    }),
    "runlength": ("run_length_weights.cu", {
        "committed": [],
        "items_4": [("kItems = 8;", "kItems = 4;")],
        "items_16": [("kItems = 8;", "kItems = 16;")],
        "threads_128": [("kThreads = 256;", "kThreads = 128;")],
        "threads_512": [("kThreads = 256;", "kThreads = 512;")],
    }),
    "merge": ("merge_runs.cu", {
        "committed": [],
        "threads_256": [("kThreads = 128;", "kThreads = 256;")],
        "threads_512": [("kThreads = 128;", "kThreads = 512;")],
        "items_16": [("kItems = 8;", "kItems = 16;")],
        "min_blocks_12": [("__launch_bounds__(kThreads)\nmerge_tiles_kernel",
                           "__launch_bounds__(kThreads, 12)\nmerge_tiles_kernel")],
        "min_blocks_16": [("__launch_bounds__(kThreads)\nmerge_tiles_kernel",
                           "__launch_bounds__(kThreads, 16)\nmerge_tiles_kernel")],
        "no_col_skew": [("return kPadTile + (P > 1 ? 32 / P : 0);",
                         "return kPadTile;")],
        # the staged columns' loads through registers, a column at a time
        "register_stage": [
            ("cp_async4(s + pad(p), p < ta ? a + p : b + bstep * (p - ta));",
             "s[pad(p)] = p < ta ? a[p] : b[bstep * (p - ta)];")],
        "cache_hints": [
            ("if (p < cnt) o[p] = s[pad(p)];",
             "if (p < cnt) __stcs(o + p, s[pad(p)]);"),
            ("o4[v] = q;", "__stcs(o4 + v, q);")],
    }),
}


def variant_source(text: str, subs) -> str:
    for old, new in subs:
        if text.count(old) != 1:
            raise ValueError(f"substitution does not match once: {old!r}")
        text = text.replace(old, new)
    return text


def build_variants(kernels, names, keep=()):
    """{(kernel, variant): bound library}, compiling all at once; only the
    variants named in `keep` when it is not empty."""
    out = kernels.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = [kernels._nvcc(), *kernels.NVCC_FLAGS]
    jobs = {}
    for src in kernels._SOURCES:
        jobs[("base", src)] = ([str(kernels.CSRC / src)], out / f"{src}.o")
    for kname in names:
        src, variants = VARIANTS[kname]
        text = (kernels.CSRC / src).read_text()
        for v, subs in variants.items():
            if keep and v not in keep:
                continue
            cu = out / f"{kname}_{v}.cu"
            cu.write_text(variant_source(text, subs))
            jobs[(kname, v)] = ([str(cu)], out / f"{kname}_{v}.o")
    procs = {key: subprocess.Popen(
        [*nvcc, "-c", "-o", str(obj), *srcs], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for key, (srcs, obj) in jobs.items()}
    for key, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {key}:\n{log}")
        regs = [ln.split(":", 1)[1].strip() for ln in log.splitlines()
                if "registers" in ln]
        print(f"built {key[0]} {key[1]}: {regs}", flush=True)
    libs = {}
    for kname in names:
        src, variants = VARIANTS[kname]
        others = [str(jobs[("base", s)][1]) for s in kernels._SOURCES
                  if s != src]
        for v in variants:
            if (kname, v) not in jobs:
                continue
            so = out / f"lib_{kname}_{v}.so"
            subprocess.run([kernels._nvcc(), "-shared", "-o", str(so),
                            str(jobs[(kname, v)][1]), *others], check=True)
            libs[(kname, v)] = kernels._bind(ctypes.CDLL(str(so)))
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=(*VARIANTS, "all"), default="all")
    ap.add_argument("--variant", action="append",
                    help="time only this variant (repeatable)")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("sweep_variants: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import kernel_us_per_call, median_ms
    from kmerind_tpu_torch import DNA, DNA16, KmerSpec
    from kmerind_tpu_torch.ops import kernels, packing, sortops
    from kmerind_tpu_torch.ops.keys import biased

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    names = tuple(VARIANTS) if args.kernel == "all" else (args.kernel,)
    keep = set(args.variant or ())
    libs = build_variants(kernels, names, keep)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def sorted_run(n, w=2, flagged=False):
        """chip_smoke.py P2's runs: k=21 (w=2) or k=127 (w=8) key words,
        or w full words behind a liveness flag."""
        words = torch.randint(-(2**31), 2**31 - 1, (n, w), dtype=torch.int32,
                              device=dev, generator=gen)
        if not flagged:
            words[:, -1] &= 0x3FF if w == 2 else 0x3FFFFFFF
        valid = torch.rand(n, device=dev, generator=gen) > 0.01
        cols, _, s_valid = sortops.sort_rows(words, (), valid,
                                             sentinel_ok=not flagged,
                                             as_cols=True)
        if flagged:
            cols = torch.cat([(~s_valid).to(torch.int32)[None], cols])
        return cols

    def copy_of(nbytes):
        """Yardstick: a device copy that reads and writes nbytes in all."""
        src = torch.zeros(nbytes // 2, dtype=torch.uint8, device=dev)
        dst = torch.empty_like(src)
        return {"copy_ of the same bytes": lambda: dst.copy_(src)}

    cases = []      # (kernel, case, call(), check(), bytes, yardsticks)
    if "extract" in names:
        for spec in (KmerSpec(21, DNA), KmerSpec(63, DNA),
                     KmerSpec(31, DNA16), KmerSpec(127, DNA),
                     KmerSpec(1024, DNA)):
            codes = torch.randint(0, spec.alphabet.size, (CHUNK,),
                                  dtype=torch.uint8, device=dev,
                                  generator=gen)
            nv = CHUNK - spec.k + 1
            pw, prc = packing.extract_canonical(codes, spec)

            def check(codes=codes, spec=spec, nv=nv, pw=pw, prc=prc):
                w, rc = kernels.extract_canonical(codes, spec)
                return (torch.equal(w[:nv], pw[:nv])
                        and torch.equal(rc[:nv], prc[:nv]))
            nbytes = kernel_bytes("extract_canonical", n=CHUNK,
                                  nwords=spec.nwords)
            cases.append(("extract", f"n={CHUNK} {spec}",
                          lambda codes=codes, spec=spec:
                          kernels.extract_canonical(codes, spec), check,
                          nbytes, copy_of(nbytes)))
    if "runlength" in names:
        rcodes = make_reads(GENOME_LEN, CHUNK // READ_LEN + 1, seed=5)
        rcodes = rcodes.reshape(-1)[:CHUNK].copy()
        rcodes[rcodes == 4] = 0
        words, _ = kernels.extract_canonical(
            torch.from_numpy(rcodes).to(dev), KmerSpec(K, DNA))
        kcols, _, s_valid = sortops.sort_rows(
            words, (), torch.arange(CHUNK, device=dev) <= CHUNK - K,
            is_stable=False, sentinel_ok=True, as_cols=True)
        table = sortops.sort_rows(torch.randint(
            -(2**31), 2**31 - 1, (1000, 2), dtype=torch.int32, device=dev,
            generator=gen), ())[0]
        pick = torch.sort(torch.randint(0, 1000, (1 << 27,), device=dev,
                                        generator=gen)).values
        for case, kc, tv in (
                (f"n={CHUNK} sorted canonical 21-mers of reads", kcols,
                 s_valid.sum(dtype=torch.int32)),
                ("n=2^27 w=2 ~1000 keys", table[pick].t().contiguous(),
                 torch.tensor(1 << 27, dtype=torch.int32, device=dev))):
            want = kernels.run_length_weights_plain(kc, tv)
            nbytes = kernel_bytes("run_length_weights", n=kc.shape[1],
                                  w=kc.shape[0])
            cases.append(("runlength", case,
                          lambda kc=kc, tv=tv:
                          kernels.run_length_weights(kc, tv),
                          lambda kc=kc, tv=tv, want=want: torch.equal(
                              kernels.run_length_weights(kc, tv), want),
                          nbytes, copy_of(nbytes)))
        del words, table, pick
    if "merge" in names:
        for na, nb, npay, w, flagged in (
                (CHUNK, CHUNK, 0, 2, False), (1 << 26, CHUNK, 0, 2, False),
                (CHUNK, CHUNK, 1, 2, False), (1 << 26, 1 << 24, 3, 2, False),
                (1 << 26, 1 << 24, 3, 2, True), (CHUNK, CHUNK, 0, 8, False),
                (1 << 26, 1 << 24, 3, 8, False),
                (1 << 22, 1 << 22, 4, 32, True)):
            a, b = sorted_run(na, w, flagged), sorted_run(nb, w, flagged)
            pa = tuple(torch.randint(0, 100, (na,), dtype=torch.int32,
                                     device=dev, generator=gen)
                       for _ in range(npay))
            pb = tuple(torch.randint(0, 100, (nb,), dtype=torch.int32,
                                     device=dev, generator=gen)
                       for _ in range(npay))
            want = kernels.merge_runs_cols_plain(a, pa, b, pb)
            cols = torch.cat([a, b], 1)
            key = ((biased(cols[0]).to(torch.int64) << 32)
                   | (cols[1].to(torch.int64) & 0xFFFFFFFF))

            def call(a=a, pa=pa, b=b, pb=pb):
                return kernels.merge_runs_cols(a, pa, b, pb)

            def check(call=call, want=want):
                k, p = call()
                return torch.equal(k, want[0]) and all(
                    torch.equal(x, y) for x, y in zip(p, want[1]))
            kw = a.shape[0]
            nbytes = kernel_bytes("merge_runs_cols", na=na, nb=nb,
                                  n_out=want[0].shape[1], w=kw, npay=npay)
            cases.append(("merge", f"{na}+{nb} w={kw} payloads={npay}", call,
                          check, nbytes, {"stable torch.sort": (
                              lambda key=key: torch.sort(key, stable=True))}))
    if "scan" in names:
        x = torch.randint(0, 2, (1 << 28,), dtype=torch.int32, device=dev,
                          generator=gen)
        want = kernels.prefix_sum_i32_plain(x)
        cases.append(("scan", "n=2^28 values 0..1",
                      lambda: kernels.prefix_sum_i32(x),
                      lambda: torch.equal(kernels.prefix_sum_i32(x), want),
                      kernel_bytes("prefix_sum_i32", n=x.shape[0]),
                      {"torch.cumsum": lambda: torch.cumsum(
                          x, 0, dtype=torch.int32),
                       **copy_of(kernel_bytes("prefix_sum_i32",
                                              n=x.shape[0]))}))

    package_lib = kernels._cuda_lib()
    times = {}
    try:
        for rnd in range(args.rounds):
            for kname, case, call, check, nbytes, yard in cases:
                for v in VARIANTS[kname][1]:
                    if (kname, v) not in libs:
                        continue
                    kernels._lib = libs[(kname, v)]
                    if not check():
                        raise AssertionError(f"{kname} {v} {case}: != plain")
                    ms = median_ms(call)
                    times.setdefault(f"{kname} {v} | {case}", []).append(ms)
                    print(f"round {rnd} {kname} {v} {case}: {ms:.4f} ms, "
                          f"{100 * bound_ms(nbytes) / ms:.1f} % of bound "
                          f"{bound_ms(nbytes):.4f} ms [{smi}]", flush=True)
                    if rnd == 0:
                        parts = kernel_us_per_call(call)
                        print(f"  kernels (device us per call): " + ", ".join(
                            f"{n} {us:.1f}" for n, us in parts.items()),
                            flush=True)
                for yname, fn in yard.items():
                    ms = median_ms(fn)
                    times.setdefault(f"{kname} {yname} | {case}",
                                     []).append(ms)
                    print(f"round {rnd} {kname} {yname} {case}: {ms:.4f} ms "
                          f"[{smi}]", flush=True)
    finally:
        kernels._lib = package_lib
    print(json.dumps({"card": smi, "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
