"""Phred quality-score codec and windowed k-mer quality.

The port's copy of ``kmerind_tpu.quality`` (after the reference's
src/index/quality_scores.hpp and quality_score_iterator.hpp):

* the codec decodes a phred byte c to ``DecodeLUT[c - min_input]``, the
  96-entry table of ``log2(1 - 10^(-q/10))`` built the way the reference's
  compiled literals were (``np.longdouble`` and a 17-decimal round-trip);
  presets Illumina18 / Sanger (33..126), Illumina13 (64..126) and
  Illumina15 (64..126, min score 3);
* a k-mer's quality is ``exp2`` of the sum of its bases' log2 probabilities,
  exactly 0.0 if any base decodes to "incorrect"
  (QualityScoreSlidingWindow, quality_score_iterator.hpp:67-180).

`window_quality` sums every window with the same binary composition of
power-of-two window sums as the JAX package, in the same order of float32
additions, and takes exp2 the way XLA does (exp of ln 2 times the sum),
so the two agree to the rounding of ``exp``.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .ops.packing import _shift_idx

__all__ = ["QualityCodec", "ILLUMINA18", "SANGER", "ILLUMINA13", "ILLUMINA15",
           "by_name", "window_quality"]

_LOWEST = np.finfo(np.float64).min
_F32_LOWEST = float(np.finfo(np.float32).min)
_LN2_F32 = float(np.float32(np.log(2.0)))


def _lut_entry(q) -> float:
    """log2(1 - 2^(q log2(10) / -10)) in long double, printed with 17
    fractional decimals and read back as a double — how the reference's
    table literals were made (quality_scores.hpp:110-113)."""
    one, ten = np.longdouble(1.0), np.longdouble(10.0)
    v = np.log2(one - np.exp2(q * np.log2(ten) / -ten))
    return float(np.format_float_positional(v, precision=17, unique=False,
                                            fractional=True))


@dataclasses.dataclass(frozen=True)
class QualityCodec:
    """Preset-parameterized phred codec (QualityScoreCodec template
    arguments)."""

    name: str
    min_input: int
    max_input: int
    min_score: int

    def _table(self, top: float, shift) -> np.ndarray:
        lut = np.empty(96, dtype=np.float64)
        for q in range(96):
            if q < max(1, self.min_score):
                lut[q] = _LOWEST
            elif q >= 94:
                lut[q] = top
            else:
                lut[q] = _lut_entry(np.longdouble(q) - shift)
        return lut

    @functools.cached_property
    def decode_lut(self) -> np.ndarray:
        """float64[96]: q -> log2 P(base correct) (DecodeLUT,
        quality_scores.hpp:113)."""
        return self._table(0.0, np.longdouble(0.0))

    @functools.cached_property
    def encode_lut(self) -> np.ndarray:
        """float64[96]: rounding boundaries of encode's upper_bound search
        (EncodeLUT, quality_scores.hpp:216)."""
        return self._table(np.finfo(np.float64).max, np.longdouble(0.5))

    def decode(self, score_bytes: np.ndarray) -> np.ndarray:
        """ASCII phred bytes -> float64 log2 probabilities."""
        idx = np.clip(np.asarray(score_bytes, np.int32) - self.min_input,
                      0, 95)
        return self.decode_lut[idx]

    def encode(self, log2_prob: np.ndarray) -> np.ndarray:
        """log2 probabilities -> ASCII phred bytes
        (quality_scores.hpp:360-373)."""
        v = np.asarray(log2_prob, dtype=np.float64)
        floor_char = (self.min_input if self.min_score == 0
                      else self.min_input + self.min_score - 1)
        idx = np.searchsorted(self.encode_lut, v, side="right")
        out = np.where(idx == 0, floor_char,
                       np.minimum(self.max_input, self.min_input + idx - 1))
        out = np.where(np.isnan(v) | (v == _LOWEST) | np.isneginf(v),
                       floor_char, out)
        out = np.where(np.isposinf(v), self.max_input, out)
        return out.astype(np.uint8)

    @functools.cached_property
    def decode_lut_f32(self) -> np.ndarray:
        """float32[96] decode table with float32's lowest for "incorrect"
        (the reference's OutT lowest when OutT = float)."""
        return np.where(self.decode_lut == _LOWEST, _F32_LOWEST,
                        self.decode_lut).astype(np.float32)


ILLUMINA18 = QualityCodec("Illumina18", 33, 126, 0)
SANGER = QualityCodec("Sanger", 33, 126, 0)
ILLUMINA13 = QualityCodec("Illumina13", 64, 126, 0)
ILLUMINA15 = QualityCodec("Illumina15", 64, 126, 3)


def by_name(name: str) -> QualityCodec:
    """Codec preset by name (quality_scores.hpp:529-542)."""
    try:
        return {c.name: c for c in (ILLUMINA18, SANGER, ILLUMINA13,
                                    ILLUMINA15)}[name]
    except KeyError:
        raise ValueError(f"unknown quality codec {name!r}") from None


def window_quality(qual_bytes: torch.Tensor, k: int,
                   codec: QualityCodec = ILLUMINA18) -> torch.Tensor:
    """float32[n] windowed k-mer quality at every window start of uint8
    phred bytes [n]: exp2 of the window's summed log2 probabilities, or
    exactly 0.0 if a base of the window decodes to "incorrect".  Rows past
    n - k are garbage (callers mask with window validity).

    The sums are power-of-two window sums S_t[i] = S_{t-1}[i] +
    S_{t-1}[i + 2^(t-1)], composed over k's binary digits from the most
    significant — the JAX package's order of float32 additions."""
    lut = torch.from_numpy(codec.decode_lut_f32).to(qual_bytes.device)
    idx = (qual_bytes.to(torch.int64) - codec.min_input).clamp(0, 95)
    logp = lut[idx]
    # the reference's guard: a base is correct iff lowest < value < 0.0
    bad = (logp <= _F32_LOWEST) | (logp >= 0.0)
    pow_sum = {0: torch.where(bad, 0.0, logp)}
    pow_bad = {0: bad}
    t = 1
    while (1 << t) <= k:
        half = 1 << (t - 1)
        pow_sum[t] = pow_sum[t - 1] + _shift_idx(pow_sum[t - 1], half)
        pow_bad[t] = pow_bad[t - 1] | _shift_idx(pow_bad[t - 1], half)
        t += 1
    wsum = any_bad = None
    consumed = 0
    for t in reversed(range(len(pow_sum))):
        if k & (1 << t):
            ps = _shift_idx(pow_sum[t], consumed)
            pb = _shift_idx(pow_bad[t], consumed)
            wsum = ps if wsum is None else wsum + ps
            any_bad = pb if any_bad is None else any_bad | pb
            consumed += 1 << t
    # exp2(x) as exp(ln2 * x) in float32, as XLA lowers it: at k = 63 the
    # product's rounding moves the result by ~1e-6 relative
    return torch.where(any_bad, 0.0, torch.exp(_LN2_F32 * wsum)).to(
        torch.float32)
