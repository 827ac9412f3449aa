"""Hand-written CUDA kernels of the main path, their wrappers and plain
versions.

The kernels replace the Pallas kernels of
``kmerind_tpu/ops/pallas_kernels.py``:

* K1 `extract_canonical` (``csrc/extract_canonical.cu``) — plain version
  ``ops/packing.py::extract_canonical``;
* K2 `merge_runs_cols` (``csrc/merge_runs.cu``) — plain version
  `merge_runs_cols_plain`;
* K2′ `merge_sorted_runs` — the same source with row-major keys, plain
  version `merge_sorted_runs_plain`;
* the one-run bitonic merges `bitonic_merge_rows` / `bitonic_merge_cols`
  — the same source, one bitonic run read in place, plain versions
  `bitonic_merge_rows_plain` / `bitonic_merge_cols_plain` (the JAX
  package's half-cleaner network);
* K3 `prefix_sum_i32` (``csrc/prefix_sum.cu``) — plain version
  `prefix_sum_i32_plain`;
* K4 `run_length_weights` (``csrc/run_length_weights.cu``) — plain version
  `run_length_weights_plain`.

Each wrapper takes the plain version for tensors on the CPU and, for CUDA
tensors, launches its kernel or raises: nothing falls back.  It checks
device, dtype, shape and contiguity, allocates outputs with `torch.empty`,
launches on the current stream, raises on a non-zero ``cudaGetLastError()``
and adds one to ``LAUNCHES[name]`` per call that launched (K1 also to
``K1_LAUNCHES[variant]``, the kernel it picked; K2 also to
``K2_PAYLOAD_LAUNCHES[npay]``, by its number of payload columns).

The sources are compiled by ``nvcc`` for ``sm_90a`` — one process per
source, all at once, then one link — into a shared library with a plain C
interface, loaded with ctypes, at first use (`build`).  The library lands
in ``kmerind_tpu_torch/_build/`` under a name that carries a hash of the
sources and flags, so a stale build is never loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

import numpy as np
import torch

from ..kmer import KmerSpec
from . import packing
from .keys import SENTINEL, biased, lex_argsort

__all__ = ["LAUNCHES", "K1_LAUNCHES", "K2_PAYLOAD_LAUNCHES", "KERNELS",
           "build", "reset_launches",
           "extract_canonical", "k1_kernel",
           "merge_runs_cols", "merge_runs_cols_plain",
           "merge_sorted_runs", "merge_sorted_runs_plain",
           "bitonic_merge_rows", "bitonic_merge_rows_plain",
           "bitonic_merge_cols", "bitonic_merge_cols_plain",
           "prefix_sum_i32", "prefix_sum_i32_plain",
           "run_length_weights", "run_length_weights_plain"]

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "ops" / "csrc"
BUILD_DIR = _PKG / "_build"
_SOURCES = ("extract_canonical.cu", "merge_runs.cu", "prefix_sum.cu",
            "run_length_weights.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: name -> (source in the repo, TPU kernel it replaces)
KERNELS = {
    "extract_canonical": (
        "kmerind_tpu_torch/ops/csrc/extract_canonical.cu",
        "kmerind_tpu/ops/pallas_kernels.py:189"),
    "merge_runs_cols": (
        "kmerind_tpu_torch/ops/csrc/merge_runs.cu",
        "kmerind_tpu/ops/pallas_kernels.py:877"),
    "merge_sorted_runs": (
        "kmerind_tpu_torch/ops/csrc/merge_runs.cu",
        "kmerind_tpu/ops/pallas_kernels.py:832"),
    "bitonic_merge_rows": (
        "kmerind_tpu_torch/ops/csrc/merge_runs.cu",
        "kmerind_tpu/ops/pallas_kernels.py:832"),
    "bitonic_merge_cols": (
        "kmerind_tpu_torch/ops/csrc/merge_runs.cu",
        "kmerind_tpu/ops/pallas_kernels.py:848"),
    "prefix_sum_i32": (
        "kmerind_tpu_torch/ops/csrc/prefix_sum.cu",
        "kmerind_tpu/ops/pallas_kernels.py:1090"),
    "run_length_weights": (
        "kmerind_tpu_torch/ops/csrc/run_length_weights.cu",
        "kmerind_tpu/ops/pallas_kernels.py:351"),
}

#: launches per kernel wrapper (one per wrapper call that launched)
LAUNCHES = {name: 0 for name in KERNELS}

#: the K1 kernels, in the order of the C entry's `kernel` argument: a
#: k-mer of k * bits <= 64 (128) bits rolls in one 64-bit (128-bit)
#: integer; a wider one takes the bit-stream kernel
_K1_KERNELS = ("rolling64", "rolling128", "wide")
#: K1's launches by the kernel each picked (they sum to
#: LAUNCHES["extract_canonical"])
K1_LAUNCHES = {name: 0 for name in _K1_KERNELS}
#: K2's (`merge_runs_cols`) launches by payload count (keys only: 0; a
#: count index's weights: 1; the multimaps' ids and quality: 2-3)
K2_PAYLOAD_LAUNCHES: dict = {}

_lib = None
_build_lock = threading.Lock()
_vp = ctypes.c_void_p
_i64 = ctypes.c_int64
_int = ctypes.c_int


def reset_launches():
    for counts in (LAUNCHES, K1_LAUNCHES):
        for name in counts:
            counts[name] = 0
    K2_PAYLOAD_LAUNCHES.clear()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (nvcc on PATH or /usr/local/cuda/bin)")
    return path


def _lib_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in _SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libkmerind_kernels_{h.hexdigest()[:16]}.so"


def _bind(lib):
    """Set the C signatures of the kernel library's entries; returns lib."""
    lib.kmerind_extract_canonical.argtypes = [
        _vp, _i64, _vp, _int, _int, _int, _int, _int, _vp, _vp, _vp]
    for fn in (lib.kmerind_extract_canonical_tile,
               lib.kmerind_extract_wide_tile):
        fn.argtypes = []
        fn.restype = _int
    lib.kmerind_merge_runs.argtypes = [
        _vp, _i64, _vp, _i64, _int, _int, _vp, _int, _vp, _i64, _vp, _vp]
    lib.kmerind_merge_runs_parts.argtypes = [_i64, _i64]
    lib.kmerind_merge_runs_parts.restype = _i64
    lib.kmerind_bitonic_merge.argtypes = [
        _vp, _i64, _int, _int, _vp, _int, _vp, _vp, _vp]
    lib.kmerind_bitonic_merge_scratch.argtypes = [_i64, _int]
    lib.kmerind_bitonic_merge_scratch.restype = _i64
    lib.kmerind_prefix_sum_scratch_words.argtypes = [_i64]
    lib.kmerind_prefix_sum_scratch_words.restype = _i64
    lib.kmerind_prefix_sum_i32.argtypes = [_vp, _vp, _i64, _vp, _vp]
    lib.kmerind_run_length_tiles.argtypes = [_i64]
    lib.kmerind_run_length_tiles.restype = _i64
    lib.kmerind_run_length_weights.argtypes = [
        _vp, _int, _i64, _vp, _vp, _vp, _vp]
    for fn in (lib.kmerind_extract_canonical, lib.kmerind_merge_runs,
               lib.kmerind_bitonic_merge, lib.kmerind_prefix_sum_i32,
               lib.kmerind_run_length_weights):
        fn.restype = _int
    return lib


def build() -> dict:
    """Compile (if not built yet) and load the kernel library.

    Returns {"path", "seconds", "log"}: seconds spent in nvcc (0.0 when an
    up-to-date library was already on disk) and its output, which holds
    ptxas's per-kernel register / shared-memory report."""
    global _lib
    with _build_lock:
        path = _lib_path()
        seconds, log = 0.0, ""
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            objs = [tmp.with_suffix(f".{src}.o") for src in _SOURCES]
            t0 = time.perf_counter()
            procs = [subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC / src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for src, obj in zip(_SOURCES, objs)]
            logs = [proc.communicate()[0] for proc in procs]
            link = subprocess.run(
                [_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)],
                capture_output=True, text=True) if all(
                proc.returncode == 0 for proc in procs) else None
            seconds = time.perf_counter() - t0
            log = "".join(logs) + (link.stdout + link.stderr if link else "")
            for obj in objs:
                obj.unlink(missing_ok=True)
            if link is None or link.returncode != 0:
                raise RuntimeError(f"nvcc failed:\n{log}")
            os.replace(tmp, path)
        if _lib is None:
            _lib = _bind(ctypes.CDLL(str(path)))
        return {"path": str(path), "seconds": seconds, "log": log}


def _cuda_lib():
    if _lib is None:
        build()
    return _lib


def _check_cuda(name: str, t: torch.Tensor, dtype, ndim: int, device):
    if t.device != device or t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor on {device}, "
                         f"got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {t.dim()}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def _launched(name: str, rc: int):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed "
                           f"(cudaGetLastError {rc})")
    LAUNCHES[name] += 1


def _stream(device) -> int:
    """The raw cudaStream_t of the current stream on `device` (the call
    PyTorch's own generated kernels use: no Stream object is built, which
    costs ~6 us a launch through torch.cuda.current_stream)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


# ---------------------------------------------------------------- K1
#: spec -> (complement table, its address, k, bits, cpw, nwords, kernel):
#: the launch arguments of K1 that depend on the spec alone
_k1_args: dict = {}


def k1_kernel(spec: KmerSpec) -> str:
    """The K1 kernel the wrapper launches for `spec`, by the k-mer's width
    alone: "rolling64", "rolling128" or, above 128 bits, "wide"."""
    kb = spec.k * spec.bits_per_char
    return _K1_KERNELS[0 if kb <= 64 else 1 if kb <= 128 else 2]


def _k1_launch_args(spec: KmerSpec) -> tuple:
    """K1's spec-dependent launch arguments, built once per spec: first the
    alphabet's complement as a 256-entry uint8 table (identity past the
    alphabet), kept referenced here while the kernel reads its address."""
    args = _k1_args.get(spec)
    if args is None:
        lut = np.arange(256, dtype=np.uint8)
        comp = spec.alphabet.to_complement
        lut[: comp.shape[0]] = comp
        args = _k1_args[spec] = (
            lut, lut.ctypes.data, spec.k, spec.bits_per_char,
            spec.chars_per_word, spec.nwords,
            _K1_KERNELS.index(k1_kernel(spec)))
    return args


def extract_canonical(codes: torch.Tensor, spec: KmerSpec):
    """K1: (canonical int32[n, nwords], was_rc bool[n]) at every window
    start; rows past n-k are garbage.  For a CUDA tensor the words are a
    [n, nwords] view of the kernel's column-major [nwords, n] output; any
    k whose tile fits the card's shared memory (DNA k up to ~150,000)."""
    if codes.device.type == "cpu":
        return packing.extract_canonical(codes, spec)
    _check_cuda("extract_canonical", codes, torch.uint8, 1, codes.device)
    n = codes.shape[0]
    words = torch.empty((spec.nwords, n), dtype=torch.int32,
                        device=codes.device)
    was_rc = torch.empty(n, dtype=torch.bool, device=codes.device)
    if n:
        args = _k1_launch_args(spec)
        rc = _cuda_lib().kmerind_extract_canonical(
            codes.data_ptr(), n, *args[1:], words.data_ptr(),
            was_rc.data_ptr(), _stream(codes.device))
        _launched("extract_canonical", rc)
        K1_LAUNCHES[_K1_KERNELS[args[-1]]] += 1
    return words.t(), was_rc


# ---------------------------------------------------------------- K2
def _merged_len(na: int, nb: int) -> int:
    return 1 << max(1, (na + nb - 1).bit_length())


def merge_runs_cols_plain(a_keys, a_payloads, b_keys, b_payloads):
    """Plain K2: concatenate A, B and the sentinel pad, then one stable
    lexicographic sort (ties keep A before B, as the kernel does)."""
    w, na = a_keys.shape
    nb = b_keys.shape[1]
    pad = _merged_len(na, nb) - na - nb
    keys = torch.cat([a_keys, b_keys, torch.full(
        (w, pad), SENTINEL, dtype=a_keys.dtype, device=a_keys.device)], 1)
    perm = lex_argsort([biased(keys[j]) for j in range(w)], stable=True)
    pays = tuple(torch.cat([pa, pb, torch.zeros(pad, dtype=pa.dtype,
                                                device=pa.device)])[perm]
                 for pa, pb in zip(a_payloads, b_payloads))
    return keys[:, perm], pays


def merge_runs_cols(a_keys, a_payloads, b_keys, b_payloads):
    """K2: merge two ascending column-major runs.

    a_keys int32[w, na], b_keys int32[w, nb] (uint32 key words, compared
    lexicographically as unsigned; any w >= 1), payloads tuples of int32
    [na] / [nb] (any number).  Returns (keys int32[w, n], payloads) with n
    = next_pow2(na + nb): the merged run followed by sentinel rows with
    payload 0.  Ties keep A first."""
    if a_keys.device.type == "cpu":
        return merge_runs_cols_plain(a_keys, a_payloads, b_keys, b_payloads)
    return _merge("merge_runs_cols", a_keys, a_payloads, b_keys, b_payloads,
                  row_major=False)


def _merge(name, a_keys, a_payloads, b_keys, b_payloads, row_major):
    """Check and launch K2 (its partition and tile launches, with the
    partition scratch and the payload table's room from `torch.empty`) on
    column-major ([w, n]) or row-major ([n, w]) key runs; counts one launch
    under `name`."""
    dev = a_keys.device
    _check_cuda(f"{name} a_keys", a_keys, torch.int32, 2, dev)
    _check_cuda(f"{name} b_keys", b_keys, torch.int32, 2, dev)
    (na, w), (nb, wb) = ((a_keys.shape, b_keys.shape) if row_major else
                         (a_keys.shape[::-1], b_keys.shape[::-1]))
    if w < 1 or wb != w:
        raise ValueError(f"{name}: runs of {w} and {wb} key words")
    npay = len(a_payloads)
    if len(b_payloads) != npay:
        raise ValueError(f"{name}: {npay} and {len(b_payloads)} payloads")
    for p, m in [(p, na) for p in a_payloads] + [(p, nb) for p in b_payloads]:
        _check_cuda(f"{name} payload", p, torch.int32, 1, dev)
        if p.shape[0] != m:
            raise ValueError(f"{name}: payload length != run length")
    n = _merged_len(na, nb)
    out_keys = torch.empty((n, w) if row_major else (w, n),
                           dtype=torch.int32, device=dev)
    out_pays = tuple(torch.empty(n, dtype=torch.int32, device=dev)
                     for _ in range(npay))
    table = (ctypes.c_void_p * (3 * npay))(
        *(p.data_ptr() for p in (*a_payloads, *b_payloads, *out_pays)))
    lib = _cuda_lib()
    scratch = torch.empty(lib.kmerind_merge_runs_parts(na, nb) + 3 * npay,
                          dtype=torch.int64, device=dev)
    rc = lib.kmerind_merge_runs(
        a_keys.data_ptr(), na, b_keys.data_ptr(), nb, w, int(row_major),
        ctypes.cast(table, _vp), npay, out_keys.data_ptr(), n,
        scratch.data_ptr(), _stream(dev))
    _launched(name, rc)
    if not row_major:
        K2_PAYLOAD_LAUNCHES[npay] = K2_PAYLOAD_LAUNCHES.get(npay, 0) + 1
    return out_keys, out_pays


# ---------------------------------------------------------------- K2′
def merge_sorted_runs_plain(a_keys, a_payloads, b_keys, b_payloads):
    """Plain K2′: `merge_runs_cols_plain` on the transposed runs."""
    keys, pays = merge_runs_cols_plain(a_keys.t(), a_payloads, b_keys.t(),
                                       b_payloads)
    return keys.t().contiguous(), pays


def merge_sorted_runs(a_keys, a_payloads, b_keys, b_payloads):
    """K2′: merge two ascending ROW-major runs (int32[n_i, w] key rows,
    aligned int32 payloads) — K2's source with row-major loads and stores,
    no transposes.  Returns (keys int32[n, w], payloads), n = next_pow2(na
    + nb), sentinel rows with payload 0 at the tail; ties keep A first."""
    if a_keys.device.type == "cpu":
        return merge_sorted_runs_plain(a_keys, a_payloads, b_keys,
                                       b_payloads)
    return _merge("merge_sorted_runs", a_keys, tuple(a_payloads), b_keys,
                  tuple(b_payloads), row_major=True)


# ------------------------------------------------- one bitonic run
def _lex_cmp(a_cols, b_cols):
    """(a < b, a > b) row-wise over aligned int32-held uint32 word columns,
    word 0 most significant."""
    less = torch.zeros(a_cols[0].shape, dtype=torch.bool,
                       device=a_cols[0].device)
    gt = torch.zeros_like(less)
    for a, b in zip(reversed(a_cols), reversed(b_cols)):
        a, b = biased(a), biased(b)
        less = torch.where(a != b, a < b, less)
        gt = torch.where(a != b, a > b, gt)
    return less, gt


def _half_cleaners(cols: list, w: int) -> list:
    """The JAX package's bitonic network over aligned [n] columns (the
    first w the key words, the rest payloads), n a power of two: log2(n)
    half-cleaner stages; at distance d row i meets row i ^ d, the lower
    row keeps the smaller key, ties keep their own rows."""
    n = cols[0].shape[0]
    idx = torch.arange(n, device=cols[0].device)
    d = n >> 1
    while d:
        is_lo = (idx & d) == 0
        partner = [torch.where(is_lo, torch.roll(c, -d), torch.roll(c, d))
                   for c in cols]
        less, gt = _lex_cmp(cols[:w], partner[:w])
        take = torch.where(is_lo, gt, less)
        cols = [torch.where(take, p, c) for c, p in zip(cols, partner)]
        d >>= 1
    return cols


def bitonic_merge_rows_plain(keys: torch.Tensor, payloads=()):
    """Plain `bitonic_merge_rows`: the half-cleaner network (any payload
    dtype)."""
    w = keys.shape[1]
    cols = _half_cleaners([keys[:, j] for j in range(w)] + list(payloads), w)
    return torch.stack(cols[:w], dim=1), tuple(cols[w:])


def bitonic_merge_cols_plain(kcols: torch.Tensor, payloads=()):
    """Plain `bitonic_merge_cols`: the half-cleaner network (any payload
    dtype)."""
    w = kcols.shape[0]
    cols = _half_cleaners(list(kcols) + list(payloads), w)
    return torch.stack(cols[:w]), tuple(cols[w:])


def bitonic_merge_rows(keys: torch.Tensor, payloads=()):
    """Sort one bitonic run of ROW-major keys int32[n, w] (ascending rows,
    then descending; uint32 words compared as unsigned, any w >= 1; n a
    power of two) carrying int32[n] payloads (any number).  On the card:
    a split launch finds the first descent, then K2's merge takes the
    prefix as A and reads the suffix backwards as B, in place — no host
    read, no copies; ties take the prefix first.  Returns (keys int32[n,
    w], payloads) of exactly n rows."""
    if keys.device.type == "cpu":
        return bitonic_merge_rows_plain(keys, tuple(payloads))
    return _bitonic("bitonic_merge_rows", keys, tuple(payloads),
                    row_major=True)


def bitonic_merge_cols(kcols: torch.Tensor, payloads=()):
    """`bitonic_merge_rows` over COLUMN-major keys int32[w, n]."""
    if kcols.device.type == "cpu":
        return bitonic_merge_cols_plain(kcols, tuple(payloads))
    return _bitonic("bitonic_merge_cols", kcols, tuple(payloads),
                    row_major=False)


def _bitonic(name, keys, payloads, row_major):
    """Check and launch the one-run merge (memset, split, partition and
    tile launches; scratch from `torch.empty`); counts one launch under
    `name`.  An empty run launches nothing."""
    dev = keys.device
    _check_cuda(f"{name} keys", keys, torch.int32, 2, dev)
    n, w = keys.shape if row_major else keys.shape[::-1]
    if w < 1:
        raise ValueError(f"{name}: a run of {w} key words")
    if n & (n - 1):
        raise ValueError(f"{name} needs power-of-two length, got {n}")
    for p in payloads:
        _check_cuda(f"{name} payload", p, torch.int32, 1, dev)
        if p.shape[0] != n:
            raise ValueError(f"{name}: payload length != run length")
    out_keys = torch.empty_like(keys)
    out_pays = tuple(torch.empty_like(p) for p in payloads)
    if n == 0:
        return out_keys, out_pays
    npay = len(payloads)
    table = (ctypes.c_void_p * (3 * npay))(
        *(p.data_ptr() for p in (*payloads, *payloads, *out_pays)))
    lib = _cuda_lib()
    scratch = torch.empty(lib.kmerind_bitonic_merge_scratch(n, npay),
                          dtype=torch.int64, device=dev)
    rc = lib.kmerind_bitonic_merge(
        keys.data_ptr(), n, w, int(row_major), ctypes.cast(table, _vp),
        npay, out_keys.data_ptr(), scratch.data_ptr(), _stream(dev))
    _launched(name, rc)
    return out_keys, out_pays


# ---------------------------------------------------------------- K3
def prefix_sum_i32_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain K3: inclusive sum, wrapped to int32 (modulo 2^32)."""
    return torch.cumsum(x, 0, dtype=torch.int64).to(torch.int32)


def prefix_sum_i32(x: torch.Tensor) -> torch.Tensor:
    """K3: inclusive prefix sum of int32[n], wrapping modulo 2^32 like the
    JAX package's int32 cumsum."""
    if x.device.type == "cpu":
        return prefix_sum_i32_plain(x)
    _check_cuda("prefix_sum_i32", x, torch.int32, 1, x.device)
    n = x.shape[0]
    out = torch.empty_like(x)
    if n:
        lib = _cuda_lib()
        scratch = torch.empty(lib.kmerind_prefix_sum_scratch_words(n),
                              dtype=torch.int64, device=x.device)
        rc = lib.kmerind_prefix_sum_i32(x.data_ptr(), out.data_ptr(), n,
                                        scratch.data_ptr(),
                                        _stream(x.device))
        _launched("prefix_sum_i32", rc)
    return out


# ---------------------------------------------------------------- K4
def run_length_weights_plain(kcols: torch.Tensor,
                             total_valid) -> torch.Tensor:
    """Plain K4: run ids from a cumsum of the head flags, each row's run
    start gathered from the head positions (torch's cummax is a slow
    single-block scan on CUDA)."""
    w, n = kcols.shape
    if n == 0:
        return torch.zeros(0, dtype=torch.int32, device=kcols.device)
    idx = torch.arange(n, device=kcols.device)
    neq = (kcols[:, 1:] != kcols[:, :-1]).any(dim=0)
    one = torch.ones(1, dtype=torch.bool, device=kcols.device)
    head = torch.cat([one, neq])
    end = torch.cat([neq, one]) | (idx == total_valid - 1)
    start = idx[head][torch.cumsum(head, 0) - 1]
    return torch.where((idx < total_valid) & end, idx - start + 1,
                       0).to(torch.int32)


def run_length_weights(kcols: torch.Tensor, total_valid) -> torch.Tensor:
    """K4: int32[n] run lengths of sorted keys.

    kcols int32[w, n]: column-major key words sorted lexicographically over
    the rows, the first `total_valid` rows valid (an int32 0-d tensor on the
    keys' device; the kernel reads it there).  out[j] is the length of row
    j's run of equal keys when j is the run's last valid row (the next row
    differs, or j == total_valid - 1), else 0."""
    if kcols.device.type == "cpu":
        return run_length_weights_plain(kcols, total_valid)
    dev = kcols.device
    _check_cuda("run_length_weights keys", kcols, torch.int32, 2, dev)
    _check_cuda("run_length_weights total_valid", total_valid, torch.int32,
                0, dev)
    w, n = kcols.shape
    if w < 1:
        raise ValueError("run_length_weights needs at least one key word")
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n:
        lib = _cuda_lib()
        scratch = torch.empty(2 * lib.kmerind_run_length_tiles(n),
                              dtype=torch.int64, device=dev)
        rc = lib.kmerind_run_length_weights(
            kcols.data_ptr(), w, n, total_valid.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), _stream(dev))
        _launched("run_length_weights", rc)
    return out
