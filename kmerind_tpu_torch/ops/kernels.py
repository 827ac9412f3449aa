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
  `run_length_weights_plain`;

and four that replace no Pallas kernel:

* `run_count_lookup` (``csrc/run_lookup.cu``) — a count batch's lookup
  over all runs of a count index's shard, plain version
  `run_count_lookup_plain` (the per-run searches of ``index/store.py``);
* `run_vec_lookup` (the same source, the same search) — a de Bruijn
  graph's node lookup over all runs of a shard: 9 counter differences and
  a quality graph's float64 sum, plain version `run_vec_lookup_plain`;
* `position_ids` (``csrc/position_ids.cu``) — each base's 64-bit position
  id from its record's word and its offset in the record, plain version
  `position_ids_plain` (the JAX package builds them on the host,
  ``ReadBatch.short_ids`` / ``long_ids``);
* `bimol_min_rep` (``csrc/bimol_min_rep.cu``) — a Bimolecule store's
  representative minimum, each row's key-run minimum id and its strand,
  plain version `bimol_min_rep_plain` (the JAX package's associative
  scan, ``store._segmented_min_rep``).

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
from .keys import SENTINEL, biased, lex_argsort, to_u64

__all__ = ["LAUNCHES", "K1_LAUNCHES", "K2_PAYLOAD_LAUNCHES", "KERNELS",
           "build", "reset_launches",
           "extract_canonical", "k1_kernel",
           "merge_runs_cols", "merge_runs_cols_plain",
           "merge_sorted_runs", "merge_sorted_runs_plain",
           "bitonic_merge_rows", "bitonic_merge_rows_plain",
           "bitonic_merge_cols", "bitonic_merge_cols_plain",
           "prefix_sum_i32", "prefix_sum_i32_plain",
           "run_length_weights", "run_length_weights_plain",
           "run_count_lookup", "run_count_lookup_plain",
           "run_vec_lookup", "run_vec_lookup_plain",
           "position_ids", "position_ids_plain",
           "bimol_min_rep", "bimol_min_rep_plain"]

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "ops" / "csrc"
BUILD_DIR = _PKG / "_build"
_SOURCES = ("extract_canonical.cu", "merge_runs.cu", "prefix_sum.cu",
            "run_length_weights.cu", "run_lookup.cu", "position_ids.cu",
            "bimol_min_rep.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: name -> (source in the repo, TPU kernel it replaces or None)
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
    "run_count_lookup": (
        "kmerind_tpu_torch/ops/csrc/run_lookup.cu", None),
    "run_vec_lookup": (
        "kmerind_tpu_torch/ops/csrc/run_lookup.cu", None),
    "position_ids": (
        "kmerind_tpu_torch/ops/csrc/position_ids.cu", None),
    "bimol_min_rep": (
        "kmerind_tpu_torch/ops/csrc/bimol_min_rep.cu", None),
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
    lib.kmerind_run_count_lookup_max_runs.argtypes = []
    lib.kmerind_run_count_lookup.argtypes = [
        _vp, _i64, _int, _vp, _vp, _vp, _vp, _vp, _int, _int, _int, _int,
        _i64, _vp, _vp]
    lib.kmerind_run_vec_lookup.argtypes = [
        _vp, _i64, _int, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _int, _int, _int,
        _int, _int, _i64, _vp, _vp, _vp]
    lib.kmerind_position_ids.argtypes = [
        _vp, _vp, _int, _vp, _i64, _i64, _vp, _vp, _vp]
    lib.kmerind_bimol_min_rep_scratch_words.argtypes = [_i64]
    lib.kmerind_bimol_min_rep_scratch_words.restype = _i64
    lib.kmerind_bimol_min_rep.argtypes = [
        _vp, _int, _i64, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp]
    for fn in (lib.kmerind_extract_canonical, lib.kmerind_merge_runs,
               lib.kmerind_bitonic_merge, lib.kmerind_prefix_sum_i32,
               lib.kmerind_run_length_weights,
               lib.kmerind_run_count_lookup_max_runs,
               lib.kmerind_run_count_lookup, lib.kmerind_run_vec_lookup,
               lib.kmerind_position_ids, lib.kmerind_bimol_min_rep):
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


def _check_tensor(name: str, t: torch.Tensor, dtype, ndim: int, device):
    """A wrapper's input: on `device`, of `dtype`, `ndim` dims, contiguous."""
    if t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got "
                         f"{t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {t.dim()}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def _check_cuda(name: str, t: torch.Tensor, dtype, ndim: int, device):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor on {device}, "
                         f"got {t.device}")
    _check_tensor(name, t, dtype, ndim, device)


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


# ------------------------------------------------------- count lookup
def run_count_lookup_plain(exts, bstarts, queries: torch.Tensor,
                           valid: torch.Tensor,
                           saturate: int | None = None) -> torch.Tensor:
    """Plain `run_count_lookup`: ``index/store.py``'s `run_lookup_aux` (a
    bucket-seeded search unrolled on the host, then a gather) of each run,
    summed, clamped at `saturate`, 0 where not valid."""
    from ..index import store      # store imports sortops, which imports us
    total = sum((store.run_lookup_aux(ext, bstart, queries)
                 for ext, bstart in zip(exts, bstarts)),
                torch.zeros(queries.shape[0], dtype=torch.int32,
                            device=queries.device))
    if saturate is not None:
        total = total.clamp(max=saturate)
    return torch.where(valid, total, 0)


def _lookup_tables(exts, bstarts, queries: torch.Tensor, valid: torch.Tensor,
                   kname: str = "run_count_lookup", more=()) -> tuple:
    """Check a lookup kernel's arguments (all on the queries' device,
    dtypes, shapes; on the card also contiguity) — `more`: (name, tensor,
    dtype, dims) of further tables — and return (exts, bstarts, caps,
    tbits) as lists."""
    dev = queries.device
    exts, bstarts = list(exts), list(bstarts)
    if len(exts) != len(bstarts):
        raise ValueError(f"{kname}: {len(exts)} key tables and "
                         f"{len(bstarts)} bucket tables")
    for name, t, dtype, ndim in (
            ("queries", queries, torch.int32, 2),
            ("valid", valid, torch.bool, 1),
            *(("ext", e, torch.int32, 2) for e in exts),
            *(("bstart", b, torch.int32, 1) for b in bstarts), *more):
        if t.device != dev:
            raise ValueError(f"{kname} {name}: on {t.device}, the queries "
                             f"on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{kname} {name}: expected {dtype}, got "
                            f"{t.dtype}")
        if t.dim() != ndim:
            raise ValueError(f"{kname} {name}: expected {ndim} dims, got "
                             f"{t.dim()}")
        if dev.type == "cuda" and not t.is_contiguous():
            raise ValueError(f"{kname} {name}: tensor must be contiguous")
    m, w = queries.shape
    if w < 1 or valid.shape[0] != m:
        raise ValueError(f"{kname}: queries {tuple(queries.shape)} with "
                         f"valid {tuple(valid.shape)}")
    caps, tbits = [], []
    for ext, bstart in zip(exts, bstarts):
        if ext.shape[0] != w + 1 or ext.shape[1] >= 1 << 31:
            raise ValueError(f"{kname}: ext {tuple(ext.shape)} for "
                             f"{w}-word keys")
        nb = bstart.shape[0]
        tb = (nb - 1).bit_length() - 1
        if tb < 0 or nb != (1 << tb) + 1:
            raise ValueError(f"{kname}: bucket table of {nb} entries is not "
                             "2^tbits + 1")
        caps.append(ext.shape[1])
        tbits.append(tb)
    return exts, bstarts, caps, tbits


def run_count_lookup(exts, bstarts, queries: torch.Tensor,
                     valid: torch.Tensor,
                     saturate: int | None = None) -> torch.Tensor:
    """int32[m]: per query row, the sum over a shard's runs of the row's
    run total (0 where the key is absent), wrapping as int32, clamped at
    `saturate` when given, 0 where `valid` is False.

    exts, bstarts: each run's `store.run_query_aux` — ext int32[w + 1, cap]
    (sorted key columns, then the run totals), bstart int32[2^tbits + 1];
    queries int32[m, w] row-major, valid bool[m].  On the card one launch
    per (up to) 16 runs, the size of the kernel's run table: the runs'
    searches in one thread per query, no host read."""
    exts, bstarts, caps, tbits = _lookup_tables(exts, bstarts, queries,
                                                valid)
    dev = queries.device
    if dev.type == "cpu":
        return run_count_lookup_plain(exts, bstarts, queries, valid,
                                      saturate)
    if dev.type != "cuda":
        raise ValueError(f"run_count_lookup: expected a CUDA or CPU tensor, "
                         f"got {dev}")
    m, w = queries.shape
    out = torch.empty(m, dtype=torch.int32, device=dev)
    if m == 0:
        return out
    lib = _cuda_lib()
    per = lib.kmerind_run_count_lookup_max_runs()
    nruns = len(caps)
    for first in range(0, max(nruns, 1), per):
        sl = slice(first, first + per)
        n = len(caps[sl])
        tables = ((_vp * n)(*(e.data_ptr() for e in exts[sl])),
                  (_vp * n)(*(b.data_ptr() for b in bstarts[sl])),
                  (_i64 * n)(*caps[sl]), (_int * n)(*tbits[sl]))
        rc = lib.kmerind_run_count_lookup(
            queries.data_ptr(), m, w, valid.data_ptr(),
            *(ctypes.cast(t, _vp) for t in tables), n, int(first > 0),
            int(first + per >= nruns), int(saturate is not None),
            0 if saturate is None else saturate, out.data_ptr(),
            _stream(dev))
        _launched("run_count_lookup", rc)
    return out


# ------------------------------------------------------- graph node lookup
def run_vec_lookup_plain(tables, queries: torch.Tensor, valid: torch.Tensor,
                         saturate: int | None = None):
    """Plain `run_vec_lookup`: ``index/store.py``'s `run_vec_lookup_aux` (a
    bucket-seeded search unrolled on the host, then a [9, 2m] gather of the
    counter table) of each run, summed in run order, clamped at `saturate`,
    0 where not valid."""
    from ..index import store      # store imports sortops, which imports us
    m, dev = queries.shape[0], queries.device
    counts = torch.zeros((m, 9), dtype=torch.int32, device=dev)
    qsum = (torch.zeros(m, dtype=torch.float64, device=dev)
            if tables and tables[0][3] is not None else None)
    for ext, bstart, bsum, qcsum in tables:
        c, q = store.run_vec_lookup_aux(ext, bstart, bsum, qcsum, queries)
        counts = counts + c
        if qsum is not None:
            qsum = qsum + q
    if saturate is not None:
        counts = counts.clamp(max=saturate)
    counts = torch.where(valid[:, None], counts, 0)
    return counts, None if qsum is None else torch.where(valid, qsum, 0.0)


def run_vec_lookup(tables, queries: torch.Tensor, valid: torch.Tensor,
                   saturate: int | None = None):
    """(counts int32[m, 9], qsum float64[m] or None): per query row, the
    sum over a shard's graph runs of the key's 9 counters (0 where absent),
    wrapping as int32, clamped at `saturate` when given; qsum the float64
    sum of its quality sums, added in run order from 0.0, when the runs
    carry them; both 0 where `valid` is False.

    tables: per run (ext, bstart, bsum, qcsum) — its
    `store.run_vec_query_aux` (ext int32[w + 1, cap]: sorted key columns,
    then each row's key run length; bstart int32[2^tbits + 1]), its counter
    table bsum int32[9, cap] and a quality run's qcsum float64[cap] (None
    on every run of a plain graph); queries int32[m, w] row-major, valid
    bool[m].  On the card one launch per (up to) 16 runs, as
    `run_count_lookup`: the same search, then every hit run's two prefix
    reads a counter, no host read."""
    tables = [tuple(t) for t in tables]
    if any(len(t) != 4 for t in tables):
        raise ValueError("run_vec_lookup: a run's tables are (ext, bstart, "
                         "bsum, qcsum)")
    quality = bool(tables) and tables[0][3] is not None
    if any((t[3] is not None) != quality for t in tables):
        raise ValueError("run_vec_lookup: quality sums on some runs only")
    exts, bstarts, bsums, qcsums = (list(c) for c in zip(*tables)) \
        if tables else ([], [], [], [])
    more = [("bsum", b, torch.int32, 2) for b in bsums]
    if quality:
        more += [("qcsum", q, torch.float64, 1) for q in qcsums]
    exts, bstarts, caps, tbits = _lookup_tables(
        exts, bstarts, queries, valid, "run_vec_lookup", more)
    for r, cap in enumerate(caps):
        if tuple(bsums[r].shape) != (9, cap):
            raise ValueError(f"run_vec_lookup: run {r}'s counter table "
                             f"{tuple(bsums[r].shape)} for {cap} rows")
        if quality and tuple(qcsums[r].shape) != (cap,):
            raise ValueError(f"run_vec_lookup: run {r}'s quality sums "
                             f"{tuple(qcsums[r].shape)} for {cap} rows")
    dev = queries.device
    if dev.type == "cpu":
        return run_vec_lookup_plain(tables, queries, valid, saturate)
    if dev.type != "cuda":
        raise ValueError(f"run_vec_lookup: expected a CUDA or CPU tensor, "
                         f"got {dev}")
    m, w = queries.shape
    out = torch.empty((m, 9), dtype=torch.int32, device=dev)
    qout = torch.empty(m, dtype=torch.float64, device=dev) if quality \
        else None
    if m == 0:
        return out, qout
    lib = _cuda_lib()
    per = lib.kmerind_run_count_lookup_max_runs()
    nruns = len(caps)
    for first in range(0, max(nruns, 1), per):
        sl = slice(first, first + per)
        n = len(caps[sl])
        tables = [(_vp * n)(*(t.data_ptr() for t in ts[sl])) for ts in
                  (exts, bstarts, bsums, qcsums if quality else [])]
        tables += [(_i64 * n)(*caps[sl]), (_int * n)(*tbits[sl])]
        rc = lib.kmerind_run_vec_lookup(
            queries.data_ptr(), m, w, valid.data_ptr(),
            *(ctypes.cast(t, _vp) for t in tables), n, int(quality),
            int(first > 0), int(first + per >= nruns),
            int(saturate is not None), 0 if saturate is None else saturate,
            out.data_ptr(), 0 if qout is None else qout.data_ptr(),
            _stream(dev))
        _launched("run_vec_lookup", rc)
    return out, qout


# ------------------------------------------------------- position ids
_POS40 = (1 << 40) - 1
#: id kind -> the dtype of the per-base offsets `position_ids` takes
#: (int16 / int32 holding the uint16 / uint32 bits)
ID_OFF_DTYPES = {"short": torch.int16, "long": torch.int32}


def position_ids_plain(seg: torch.Tensor, off: torch.Tensor,
                       table: torch.Tensor, kind: str):
    """Plain `position_ids`: a gather of the record words, then the id's
    bit operations in int64."""
    live = (seg >= 0) & (seg < table.shape[0])
    if table.shape[0]:
        w = table[torch.where(live, seg, 0).to(torch.int64)]
    else:
        w = torch.zeros(seg.shape, dtype=torch.int64, device=seg.device)
    if kind == "short":
        ids = w | (off.to(torch.int64) & 0xFFFF)
    else:
        o = off.to(torch.int64) & 0xFFFFFFFF
        ids = (w & ~_POS40) | (((w & _POS40) + o) & _POS40)
    ids = torch.where(live, ids, 0)
    return (ids >> 32).to(torch.int32), ids.to(torch.int32)


def position_ids(seg: torch.Tensor, off: torch.Tensor, table: torch.Tensor,
                 kind: str):
    """(id_hi, id_lo) int32, seg's shape: each base's 64-bit position id
    (`ReadBatch.short_ids` / `long_ids` of `kind`) split into its uint32
    halves.

    seg int32 (each base's record, < 0 on padding), off the base's byte
    offset in its record (`ID_OFF_DTYPES[kind]`: int16 holding the low 16
    bits a short id keeps, int32 holding the uint32), seg's shape; table
    int64[r] each record's word as uint64 bits — short: fid << 56 |
    (record_start & POS40) << 16; long: fid << 56 | seq_index << 40 |
    (record_start & POS40).  A short id is the word | the offset; a long
    one the word's top 24 bits | (its low 40 + the offset) & POS40, which
    is global_pos & POS40 where global_pos == record_start +
    offset_in_record.  A base whose seg is < 0 or >= r gets 0.  On the
    card one launch: a thread composes 4 bases, the table read through
    L2."""
    if kind not in ID_OFF_DTYPES:
        raise ValueError(f"position_ids: unknown id kind {kind!r}")
    if off.shape != seg.shape:
        raise ValueError(f"position_ids: offsets {tuple(off.shape)} for "
                         f"seg {tuple(seg.shape)}")
    if seg.device.type == "cpu":
        for name, t, dtype in (("seg", seg, torch.int32),
                               ("off", off, ID_OFF_DTYPES[kind]),
                               ("table", table, torch.int64)):
            if t.device != seg.device:
                raise ValueError(f"position_ids {name}: on {t.device}")
            if t.dtype != dtype:
                raise TypeError(f"position_ids {name}: expected {dtype}, "
                                f"got {t.dtype}")
        return position_ids_plain(seg, off, table, kind)
    dev = seg.device
    _check_cuda("position_ids seg", seg, torch.int32, seg.dim(), dev)
    _check_cuda("position_ids off", off, ID_OFF_DTYPES[kind], seg.dim(), dev)
    _check_cuda("position_ids table", table, torch.int64, 1, dev)
    hi = torch.empty_like(seg)
    lo = torch.empty_like(seg)
    n = seg.numel()
    if n:
        rc = _cuda_lib().kmerind_position_ids(
            seg.data_ptr(), off.data_ptr(), int(kind == "long"),
            table.data_ptr(), table.shape[0], n, hi.data_ptr(),
            lo.data_ptr(), _stream(dev))
        _launched("position_ids", rc)
    return hi, lo


# ------------------------------------------------ representative minimum
_I64_MIN = torch.iinfo(torch.int64).min
_I64_MAX = torch.iinfo(torch.int64).max


def bimol_min_rep_plain(keys, weights, rep_hi, rep_lo, rep_strand):
    """Plain `bimol_min_rep`: the id packs into one int64 biased by 2^63
    (signed order = unsigned order; a dead row's is the sentinel's,
    INT64_MAX), one `scatter_reduce` "amin" per run index (a cumsum of the
    head flags) gives each run's minimum, a second over the row indices
    that hold it gives the first, and one gather broadcasts its strand.
    No cummin: a single-block scan on CUDA."""
    cap = keys.shape[1]
    dev = keys.device
    live = weights > 0
    key = ((to_u64(rep_hi) << 32) | to_u64(rep_lo)) ^ _I64_MIN
    key = torch.where(live, key, _I64_MAX)
    neq_prev = torch.ones(cap, dtype=torch.bool, device=dev)
    neq_prev[1:] = (keys[:, 1:] != keys[:, :-1]).any(dim=0)
    run_id = torch.cumsum(neq_prev, 0) - 1
    rmin = torch.full((cap,), _I64_MAX, dtype=torch.int64,
                      device=dev).scatter_reduce(0, run_id, key, "amin")
    rmin = rmin[run_id]
    rows = torch.arange(cap, device=dev)
    first = torch.full((cap,), cap, dtype=torch.int64,
                       device=dev).scatter_reduce(
        0, run_id, torch.where(key == rmin, rows, cap), "amin")
    strand = torch.where(live, rep_strand, 0)[first[run_id]]
    ident = rmin ^ _I64_MIN
    return (ident >> 32).to(torch.int32), ident.to(torch.int32), strand


def bimol_min_rep(keys, weights, rep_hi, rep_lo, rep_strand):
    """(rep_hi, rep_lo, rep_strand) int32[cap]: each row's key-run minimum
    representative — the live row with the smallest unsigned 64-bit id,
    the first such row on a tie — broadcast over the run.  A run with no
    live row reports sentinel ids and strand 0, as the JAX package's
    associative scan does.

    One shard: keys int32[w, cap] (column-major uint32 words, sorted with
    duplicates and sentinel padding; any w >= 1), weights (live where > 0),
    rep_hi / rep_lo (the id's uint32 halves) and rep_strand int32[cap],
    all contiguous on one device.  On the card one segmented scan with
    decoupled look-back over tiles of 1024 rows, then a fill of the rows
    of runs that cross a tile's right edge (three launches with the
    scratch's memset; cap < 2^31)."""
    dev = keys.device
    cols = (("weights", weights), ("rep_hi", rep_hi), ("rep_lo", rep_lo),
            ("rep_strand", rep_strand))
    check = _check_cuda if dev.type == "cuda" else _check_tensor
    check("bimol_min_rep keys", keys, torch.int32, 2, dev)
    for name, t in cols:
        check(f"bimol_min_rep {name}", t, torch.int32, 1, dev)
    w, cap = keys.shape
    if w < 1:
        raise ValueError("bimol_min_rep needs at least one key word")
    for name, t in cols:
        if t.shape[0] != cap:
            raise ValueError(f"bimol_min_rep {name}: {t.shape[0]} rows for "
                             f"{cap} keys")
    if dev.type == "cpu":
        return bimol_min_rep_plain(keys, weights, rep_hi, rep_lo, rep_strand)
    if cap >= 1 << 31:
        raise ValueError(f"bimol_min_rep: {cap} rows, at most 2^31 - 1")
    outs = tuple(torch.empty(cap, dtype=torch.int32, device=dev)
                 for _ in range(3))
    if cap:
        lib = _cuda_lib()
        scratch = torch.empty(lib.kmerind_bimol_min_rep_scratch_words(cap),
                              dtype=torch.int64, device=dev)
        rc = lib.kmerind_bimol_min_rep(
            keys.data_ptr(), w, cap, weights.data_ptr(), rep_hi.data_ptr(),
            rep_lo.data_ptr(), rep_strand.data_ptr(),
            *(o.data_ptr() for o in outs), scratch.data_ptr(), _stream(dev))
        _launched("bimol_min_rep", rc)
    return outs
