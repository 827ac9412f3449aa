"""Hand-written CUDA kernels of the main path, their wrappers and plain
versions.

Three kernels replace the Pallas kernels that the count-index main path
reaches in ``kmerind_tpu/ops/pallas_kernels.py``:

* K1 `extract_canonical` (``csrc/extract_canonical.cu``) — plain version
  ``ops/packing.py::extract_canonical``;
* K2 `merge_runs_cols` (``csrc/merge_runs.cu``) — plain version
  `merge_runs_cols_plain`;
* K3 `prefix_sum_i32` (``csrc/prefix_sum.cu``) — plain version
  `prefix_sum_i32_plain`.

Each wrapper takes the plain version for tensors on the CPU and, for CUDA
tensors, launches its kernel or raises: nothing falls back.  It checks
device, dtype, shape and contiguity, allocates outputs with `torch.empty`,
launches on the current stream, raises on a non-zero ``cudaGetLastError()``
and adds one to ``LAUNCHES[name]`` per call that launched.

The sources are compiled by ``nvcc`` for ``sm_90a`` into one shared library
with a plain C interface, loaded with ctypes, at first use (`build`).  The
library lands in ``kmerind_tpu_torch/_build/`` under a name that carries a
hash of the sources and flags, so a stale build is never loaded.
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

__all__ = ["LAUNCHES", "KERNELS", "build", "reset_launches",
           "extract_canonical", "merge_runs_cols", "merge_runs_cols_plain",
           "prefix_sum_i32", "prefix_sum_i32_plain"]

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "ops" / "csrc"
BUILD_DIR = _PKG / "_build"
_SOURCES = ("extract_canonical.cu", "merge_runs.cu", "prefix_sum.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: name -> (source in the repo, TPU kernel it replaces)
KERNELS = {
    "extract_canonical": (
        "kmerind_tpu_torch/ops/csrc/extract_canonical.cu",
        "kmerind_tpu/ops/pallas_kernels.py:189"),
    "merge_runs_cols": (
        "kmerind_tpu_torch/ops/csrc/merge_runs.cu",
        "kmerind_tpu/ops/pallas_kernels.py:877"),
    "prefix_sum_i32": (
        "kmerind_tpu_torch/ops/csrc/prefix_sum.cu",
        "kmerind_tpu/ops/pallas_kernels.py:1090"),
}

#: launches per kernel wrapper (one per wrapper call that launched)
LAUNCHES = {name: 0 for name in KERNELS}

_K1_MAX_K = 512
_lib = None
_build_lock = threading.Lock()
_vp = ctypes.c_void_p
_i64 = ctypes.c_int64
_int = ctypes.c_int


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   *(str(CSRC / s) for s in _SOURCES)]
            t0 = time.perf_counter()
            res = subprocess.run(cmd, capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            log = res.stdout + res.stderr
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed ({res.returncode}):\n{log}")
            os.replace(tmp, path)
        if _lib is None:
            lib = ctypes.CDLL(str(path))
            lib.kmerind_extract_canonical.argtypes = [
                _vp, _i64, _vp, _int, _int, _int, _int, _vp, _vp, _vp]
            lib.kmerind_merge_runs.argtypes = [
                _vp, _i64, _vp, _i64, _int, _vp, _vp, _vp, _vp, _vp, _vp,
                _int, _vp, _vp, _vp, _vp, _i64, _vp]
            lib.kmerind_prefix_sum_tiles.argtypes = [_i64]
            lib.kmerind_prefix_sum_tiles.restype = _i64
            lib.kmerind_prefix_sum_i32.argtypes = [_vp, _vp, _i64, _vp, _vp]
            for fn in (lib.kmerind_extract_canonical, lib.kmerind_merge_runs,
                       lib.kmerind_prefix_sum_i32):
                fn.restype = _int
            _lib = lib
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
    return torch.cuda.current_stream(device).cuda_stream


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


# ---------------------------------------------------------------- K1
def _comp_lut256(spec: KmerSpec) -> np.ndarray:
    lut = np.arange(256, dtype=np.uint8)
    comp = spec.alphabet.to_complement
    lut[: comp.shape[0]] = comp
    return lut


def extract_canonical(codes: torch.Tensor, spec: KmerSpec):
    """K1: (canonical int32[n, nwords], was_rc bool[n]) at every window
    start; rows past n-k are garbage.  For a CUDA tensor the words are a
    [n, nwords] view of the kernel's column-major [nwords, n] output."""
    if codes.device.type == "cpu":
        return packing.extract_canonical(codes, spec)
    _check_cuda("extract_canonical", codes, torch.uint8, 1, codes.device)
    if spec.k > _K1_MAX_K:
        raise ValueError(f"extract_canonical kernel takes k <= {_K1_MAX_K}, "
                         f"got {spec}")
    n = codes.shape[0]
    words = torch.empty((spec.nwords, n), dtype=torch.int32,
                        device=codes.device)
    was_rc = torch.empty(n, dtype=torch.bool, device=codes.device)
    if n:
        lut = _comp_lut256(spec)
        rc = _cuda_lib().kmerind_extract_canonical(
            codes.data_ptr(), n, lut.ctypes.data, spec.k, spec.bits_per_char,
            spec.chars_per_word, spec.nwords, words.data_ptr(),
            was_rc.data_ptr(), _stream(codes.device))
        _launched("extract_canonical", rc)
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
    lexicographically as unsigned), payloads tuples of int32 [na] / [nb].
    Returns (keys int32[w, n], payloads) with n = next_pow2(na + nb): the
    merged run followed by sentinel rows with payload 0.  Ties keep A
    first."""
    if a_keys.device.type == "cpu":
        return merge_runs_cols_plain(a_keys, a_payloads, b_keys, b_payloads)
    dev = a_keys.device
    w, na = a_keys.shape
    nb = b_keys.shape[1]
    npay = len(a_payloads)
    if not 1 <= w <= 5 or b_keys.shape[0] != w:
        raise ValueError(f"merge_runs_cols takes 1-5 key words, got "
                         f"{tuple(a_keys.shape)} and {tuple(b_keys.shape)}")
    if npay > 3 or len(b_payloads) != npay:
        raise ValueError("merge_runs_cols takes 0-3 payloads per run")
    _check_cuda("merge_runs_cols a_keys", a_keys, torch.int32, 2, dev)
    _check_cuda("merge_runs_cols b_keys", b_keys, torch.int32, 2, dev)
    for p, m in [(p, na) for p in a_payloads] + [(p, nb) for p in b_payloads]:
        _check_cuda("merge_runs_cols payload", p, torch.int32, 1, dev)
        if p.shape[0] != m:
            raise ValueError("merge_runs_cols: payload length != run length")
    n = _merged_len(na, nb)
    out_keys = torch.empty((w, n), dtype=torch.int32, device=dev)
    out_pays = tuple(torch.empty(n, dtype=torch.int32, device=dev)
                     for _ in range(npay))

    def three(ts):
        ps = [_ptr(t) for t in ts]
        return ps + [None] * (3 - len(ps))

    rc = _cuda_lib().kmerind_merge_runs(
        a_keys.data_ptr(), na, b_keys.data_ptr(), nb, w,
        *three(a_payloads), *three(b_payloads), npay,
        out_keys.data_ptr(), *three(out_pays), n, _stream(dev))
    _launched("merge_runs_cols", rc)
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
        scratch = torch.empty(lib.kmerind_prefix_sum_tiles(n),
                              dtype=torch.int32, device=x.device)
        rc = lib.kmerind_prefix_sum_i32(x.data_ptr(), out.data_ptr(), n,
                                        scratch.data_ptr(),
                                        _stream(x.device))
        _launched("prefix_sum_i32", rc)
    return out
