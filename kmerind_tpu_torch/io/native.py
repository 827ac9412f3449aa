"""ctypes bindings for the native fastscan parser (native/fastscan.cpp).

Loads ``native/libfastscan.so`` (building it with make on first use if the
toolchain is available) and exposes `fastq_parse` / `fasta_parse` returning
the same `ReadBatch` columns as the numpy parsers.  `available()` is False
when no compiler/lib exists, and ``engine="auto"`` callers then use the
numpy path; `require()` raises with the reason (make's error output) for
callers that need this engine.
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess

import numpy as np

from ..alphabets import Alphabet
from .batch import ReadBatch

__all__ = ["available", "require", "fastq_parse", "fasta_parse",
           "find_record_start"]

_NATIVE_DIR = pathlib.Path(__file__).resolve().parent.parent.parent / "native"
_LIB_PATH = _NATIVE_DIR / "libfastscan.so"

_ERRORS = {
    -1: "truncated record",
    -2: "record does not start with '@'",
    -3: "separator line does not start with '+'",
    -4: "sequence/quality length mismatch",
    -5: "output capacity exceeded",
}

_lib = None
_load_error: str | None = None

# Output ring pool.  Parsing emits ~18 bytes of output per input byte; on
# first touch, freshly-allocated pages fault in at ~2% of warm write
# bandwidth (measured on virtualized hosts), so all parse
# output lands in persistent ring slots that are faulted once and then
# rewritten at memory speed.  Slot rotation lets a double-buffered
# streaming consumer hold the previous batch while the next one is parsed.
_RING_SIZE = 2  # double-buffer: previous batch stays live during next parse
_COLS = (("rec", np.uint64), ("codes", np.uint8), ("quals", np.uint8),
         ("seg", np.int32), ("offs", np.uint32), ("gpos", np.uint64),
         ("ones", bool))


class _Slot:
    def __init__(self):
        self.arrays: dict[str, np.ndarray] = {}

    def get(self, name: str, n: int, dtype) -> np.ndarray:
        a = self.arrays.get(name)
        if a is None or a.shape[0] < n or a.dtype != dtype:
            a = np.empty(int(n * 1.25) + 16, dtype)
            if name == "ones":
                a[:] = True  # written once; aliased by valid AND owned
                a.flags.writeable = False
            self.arrays[name] = a
        return a[:n]


_ring = [_Slot() for _ in range(_RING_SIZE)]
_ring_pos = 0


def _next_slot() -> _Slot:
    global _ring_pos
    slot = _ring[_ring_pos]
    _ring_pos = (_ring_pos + 1) % _RING_SIZE
    return slot


def _try_load():
    global _lib, _load_error
    if _lib is not None or _load_error is not None:
        return _lib
    try:
        src = _NATIVE_DIR / "fastscan.cpp"
        stale = (_LIB_PATH.exists() and src.exists()
                 and src.stat().st_mtime > _LIB_PATH.stat().st_mtime)
        if not _LIB_PATH.exists() or stale:
            subprocess.run(
                ["make", "-C", str(_NATIVE_DIR), "-B"] if stale
                else ["make", "-C", str(_NATIVE_DIR)],
                check=True, capture_output=True, timeout=120)
        lib = ctypes.CDLL(str(_LIB_PATH))
    except subprocess.CalledProcessError as e:
        _load_error = (f"make -C {_NATIVE_DIR} failed:\n"
                       f"{e.stderr.decode(errors='replace')[-4000:]}")
        return None
    except (OSError, subprocess.SubprocessError) as e:
        _load_error = f"{type(e).__name__}: {e}"
        return None

    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    sig = [u8p, ctypes.c_int64, u8p, ctypes.c_int64,
           u64p, ctypes.c_int64,
           u8p, u8p, i32p, u32p, u64p, ctypes.c_int64, i64p]
    for name in ("fastq_parse", "fasta_parse"):
        fn = getattr(lib, name)
        fn.argtypes = sig
        fn.restype = ctypes.c_int64
    # _mt entries insert nthreads (and for FASTA the block context
    # leading_record_start / prev_line_is_header) after file_offset
    lib.fastq_parse_mt.argtypes = sig[:4] + [ctypes.c_int32] + sig[4:]
    lib.fastq_parse_mt.restype = ctypes.c_int64
    lib.fasta_parse_mt.argtypes = (
        sig[:4] + [ctypes.c_int64, ctypes.c_int32, ctypes.c_int32]
        + sig[4:])
    lib.fasta_parse_mt.restype = ctypes.c_int64
    lib.fastq_find_record_start.argtypes = [u8p, ctypes.c_int64,
                                            ctypes.c_int32]
    lib.fastq_find_record_start.restype = ctypes.c_int64
    _lib = lib
    return _lib


def available() -> bool:
    return _try_load() is not None


def require():
    """The loaded library; raises RuntimeError saying why it is not."""
    lib = _try_load()
    if lib is None:
        raise RuntimeError(f"native fastscan parser unavailable: {_load_error}")
    return lib


def _parse_threads(nbytes: int) -> int:
    """Thread count for a parse: all cores on large blocks (ranges split
    at record boundaries, two-pass count-then-fill — bit-identical to the
    serial walk); the C side falls back to serial below 4MB."""
    import os
    if nbytes < (4 << 20):
        return 1
    return max(1, min(8, os.cpu_count() or 1))


def _as_ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _parse(kind: str, data: np.ndarray, alphabet: Alphabet,
           file_offset: int, file_id: int, seq_index_base: int,
           reuse: bool, leading_record_start: int | None = None,
           prev_line_is_header: bool = False) -> ReadBatch:
    lib = require()
    data = np.ascontiguousarray(data, dtype=np.uint8)
    n = data.shape[0]
    slot = _next_slot()
    # capacities: FASTQ bases <= n/2 (each base also has a quality byte);
    # FASTA bases <= n.  Records are >= 4 bytes in both formats (FASTQ:
    # 4 lines; FASTA: a '>\n' header run + >= 1 seq byte + '\n' — runs of
    # consecutive header lines collapse into ONE record), so n/4 + slack
    # (incl. a leading mid-block record) bounds the record count.
    nrec_cap = n // 4 + 3
    nbase_cap = n // 2 + 16 if kind == "fastq" else n
    record_start = slot.get("rec", nrec_cap, np.uint64)
    codes = slot.get("codes", nbase_cap, np.uint8)
    quals = slot.get("quals", nbase_cap, np.uint8)
    seg = slot.get("seg", nbase_cap, np.int32)
    offs = slot.get("offs", nbase_cap, np.uint32)
    gpos = slot.get("gpos", nbase_cap, np.uint64)
    nb = ctypes.c_int64(0)
    head = (_as_ptr(data, ctypes.c_uint8), n,
            _as_ptr(np.ascontiguousarray(alphabet.from_ascii),
                    ctypes.c_uint8), file_offset)
    tail = (_as_ptr(record_start, ctypes.c_uint64), nrec_cap,
            _as_ptr(codes, ctypes.c_uint8), _as_ptr(quals, ctypes.c_uint8),
            _as_ptr(seg, ctypes.c_int32), _as_ptr(offs, ctypes.c_uint32),
            _as_ptr(gpos, ctypes.c_uint64), nbase_cap, ctypes.byref(nb))
    nthreads = _parse_threads(n)
    if kind == "fastq":
        assert leading_record_start is None
        nrec = lib.fastq_parse_mt(*head, nthreads, *tail)
    else:
        lead = -1 if leading_record_start is None else leading_record_start
        nrec = lib.fasta_parse_mt(*head, lead,
                                  1 if prev_line_is_header else 0,
                                  nthreads, *tail)
    if nrec < 0:
        raise ValueError(
            f"native {kind} parse failed: {_ERRORS.get(nrec, nrec)}")
    nb = nb.value
    if reuse:
        # Views into the ring slot: valid until _RING_SIZE-1 further
        # parses (= one, with the default double-buffer ring).  For
        # streaming ingest loops that consume each batch onto the device
        # before requesting the next block, this is zero-copy/zero-alloc.
        take = lambda a, m: a[:m]  # noqa: E731
    else:
        take = lambda a, m: a[:m].copy()  # noqa: E731
    return ReadBatch(
        codes=take(codes, nb),
        valid=take(slot.get("ones", nb, bool), nb) if reuse
        else np.ones(nb, bool),
        owned=take(slot.get("ones", nb, bool), nb) if reuse
        else np.ones(nb, bool),
        seg_id=take(seg, nb),
        offset_in_record=take(offs, nb),
        global_pos=take(gpos, nb),
        qual=take(quals, nb),
        record_start=take(record_start, nrec),
        seq_index=(np.arange(nrec) + seq_index_base).astype(np.uint32),
        file_id=np.full(nrec, file_id, dtype=np.uint16),
        alphabet=alphabet,
    )


def fastq_parse(data, alphabet, file_offset=0, file_id=0, seq_index_base=0,
                reuse=False):
    return _parse("fastq", data, alphabet, file_offset, file_id,
                  seq_index_base, reuse)


def fasta_parse(data, alphabet, file_offset=0, file_id=0, seq_index_base=0,
                reuse=False, leading_record_start=None,
                prev_line_is_header=False):
    return _parse("fasta", data, alphabet, file_offset, file_id,
                  seq_index_base, reuse, leading_record_start,
                  prev_line_is_header)


def find_record_start(data: np.ndarray, at_parent_start: bool) -> int:
    lib = require()
    data = np.ascontiguousarray(data, dtype=np.uint8)
    return int(lib.fastq_find_record_start(
        _as_ptr(data, ctypes.c_uint8), data.shape[0],
        1 if at_parent_start else 0))
