"""The least bytes a kernel must move, and the time that takes.

`kernel_bytes` and `bound_ms` are frozen copies of ``chip_smoke.py``
``kernel_bytes`` / ``bound_ms`` (lines 234-263 there): each input read
once and each output written once, from the call's shapes, over the
H100 SXM's published HBM3 rate.  Do not edit them: a later change to the
smoke script must not move the roofline shares this benchmark reports.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3, NVIDIA's data sheet


def kernel_bytes(kname: str, **shape) -> int:
    """Bytes a kernel must move at the least: each input read once, each
    output written once, from the call's shapes.

    extract_canonical(n, nwords): uint8 codes in; int32 [nwords, n] words
    and bool [n] was_rc out.  merge_runs_cols(na, nb, n_out, w, npay): w
    key words ([w, n] column-major) and npay payloads of int32 per row, na
    + nb rows in, n_out out; merge_sorted_runs the same with row-major [n,
    w] keys (the same bytes).  bitonic_merge_rows / bitonic_merge_cols(n,
    w, npay): one run of n rows of w key words and npay int32 payloads in,
    n rows out.  prefix_sum_i32(n): int32 in and out.
    run_length_weights(n, w): int32 [w, n] keys and the int32 valid count
    in, int32 [n] weights out."""
    if kname == "extract_canonical":
        return shape["n"] * (1 + 4 * shape["nwords"] + 1)
    if kname in ("merge_runs_cols", "merge_sorted_runs"):
        row = 4 * (shape["w"] + shape["npay"])
        return (shape["na"] + shape["nb"] + shape["n_out"]) * row
    if kname in ("bitonic_merge_rows", "bitonic_merge_cols"):
        return 2 * shape["n"] * 4 * (shape["w"] + shape["npay"])
    if kname == "prefix_sum_i32":
        return 8 * shape["n"]
    if kname == "run_length_weights":
        return 4 * shape["w"] * shape["n"] + 4 + 4 * shape["n"]
    raise KeyError(kname)


def bound_ms(nbytes: int) -> float:
    """Least milliseconds to move `nbytes` at the HBM rate."""
    return nbytes / HBM_BYTES_PER_S * 1e3
