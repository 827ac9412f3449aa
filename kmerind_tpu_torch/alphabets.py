"""Biological sequence alphabets as lookup-table arrays.

The same alphabets as ``kmerind_tpu.alphabets`` (a numpy-only copy, so the
PyTorch port imports no JAX), rebuilt from the reference's alphabet structs
(src/common/alphabets.hpp:127-737).  Each alphabet is a frozen
dataclass carrying numpy LUTs (``from_ascii``, ``to_ascii``, ``to_complement``)
that are used as gather tables host-side (numpy) and on the device (the
complement LUT feeds the extraction kernel), instead of the reference's
constexpr ``std::array`` members.

Encodings match the reference bit-for-bit so that packed k-mers decode to the
same strings:

* DNA / RNA  (2-bit): A=0 C=1 G=2 T/U=3; unknown chars map to 0 ('A'); the
  complement is ``3 - x``  (alphabets.hpp:139-185, 377-420).
* DNA6 / RNA6 (3-bit): gap=0 A=1 C=3 T/U=4 G=6 N=7, unknown→2; complement is a
  3-bit reversal (alphabets.hpp:196-280, 432-520).
* DNA16 (4-bit, loose IUPAC, U==T, gap allowed): one bit per base letter;
  complement is a 4-bit reversal (alphabets.hpp:645-726).
* DNA_IUPAC (4-bit, strict IUPAC, U distinct): same bit-per-base layout but
  U=0 and unknown→0xF (alphabets.hpp:539-632).
* ASCII (8-bit identity).

Aliases DNA5=DNA6, RNA5=RNA6 follow alphabets.hpp:727-737.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "Alphabet",
    "DNA",
    "DNA5",
    "DNA6",
    "RNA",
    "RNA5",
    "RNA6",
    "DNA16",
    "DNA_IUPAC",
    "ASCII",
    "by_name",
]


@dataclasses.dataclass(frozen=True)
class Alphabet:
    """An alphabet: LUT arrays + bit-width metadata.

    Attributes:
      name: canonical name, e.g. "DNA".
      size: number of distinct codes (reference ``SIZE``).
      bits_per_char: ceil(log2(size)) — bits used per packed char
        (reference AlphabetTraits, alphabet_traits.hpp:80).
      from_ascii: (256,) uint8 LUT ascii byte -> code.
      to_ascii: (size,) uint8 LUT code -> ascii byte.
      to_complement: (size,) uint8 LUT code -> complement code.
      valid_ascii: (256,) bool — bytes that are *explicitly* part of the
        alphabet (used by optional N-filtering, mirroring SequenceNPredicate
        in filtered_sequence_iterator.hpp:151; the reference LUTs themselves
        silently default unknown bytes).
    """

    name: str
    size: int
    bits_per_char: int
    from_ascii: np.ndarray
    to_ascii: np.ndarray
    to_complement: np.ndarray
    valid_ascii: np.ndarray

    def __post_init__(self):
        for field in ("from_ascii", "to_ascii", "to_complement", "valid_ascii"):
            getattr(self, field).setflags(write=False)

    # -- convenience -------------------------------------------------------
    def encode(self, s: str | bytes) -> np.ndarray:
        """ASCII string/bytes -> uint8 code array."""
        if isinstance(s, str):
            s = s.encode("ascii")
        b = np.frombuffer(s, dtype=np.uint8)
        return self.from_ascii[b]

    def decode(self, codes: np.ndarray) -> str:
        """uint8 code array -> ASCII string."""
        return self.to_ascii[np.asarray(codes, dtype=np.uint8)].tobytes().decode("ascii")

    def complement(self, codes: np.ndarray) -> np.ndarray:
        return self.to_complement[np.asarray(codes, dtype=np.uint8)]

    def __repr__(self):  # keep reprs short for test output
        return f"Alphabet({self.name})"

    def __hash__(self):
        return hash(self.name)

    def __eq__(self, other):
        return isinstance(other, Alphabet) and other.name == self.name


def _lut(mapping: dict[str, int], default: int) -> tuple[np.ndarray, np.ndarray]:
    """Build (from_ascii, valid_ascii) from a char->code mapping.

    Both upper and lower case of each letter map to the same code.
    """
    from_ascii = np.full(256, default, dtype=np.uint8)
    valid = np.zeros(256, dtype=bool)
    for ch, code in mapping.items():
        for c in (ch.upper(), ch.lower()):
            from_ascii[ord(c)] = code
            valid[ord(c)] = True
    return from_ascii, valid


def _make_dna() -> Alphabet:
    from_ascii, valid = _lut({"A": 0, "C": 1, "G": 2, "T": 3}, default=0)
    return Alphabet(
        name="DNA",
        size=4,
        bits_per_char=2,
        from_ascii=from_ascii,
        to_ascii=np.frombuffer(b"ACGT", dtype=np.uint8).copy(),
        to_complement=np.array([3, 2, 1, 0], dtype=np.uint8),
        valid_ascii=valid,
    )


def _make_rna() -> Alphabet:
    from_ascii, valid = _lut({"A": 0, "C": 1, "G": 2, "U": 3}, default=0)
    return Alphabet(
        name="RNA",
        size=4,
        bits_per_char=2,
        from_ascii=from_ascii,
        to_ascii=np.frombuffer(b"ACGU", dtype=np.uint8).copy(),
        to_complement=np.array([3, 2, 1, 0], dtype=np.uint8),
        valid_ascii=valid,
    )


def _make_dna6(name: str, t_char: str) -> Alphabet:
    # gap=0, A=1, C=3, T/U=4, G=6, N=7 (3-bit; complement = bit reversal).
    from_ascii, valid = _lut(
        {"-": 0, ".": 0, "A": 1, "C": 3, t_char: 4, "G": 6, "N": 7, "X": 7},
        default=2,
    )
    to_ascii = np.frombuffer(("." + "A?C" + t_char + "?GN").encode(), dtype=np.uint8).copy()
    return Alphabet(
        name=name,
        size=8,
        bits_per_char=3,
        from_ascii=from_ascii,
        to_ascii=to_ascii,
        to_complement=np.array([0, 4, 2, 6, 1, 5, 3, 7], dtype=np.uint8),
        valid_ascii=valid,
    )


_IUPAC_TO_ASCII_16 = b".ACMGRSVTWYHKDBN"  # DNA16 (code 0 = gap '.')
_IUPAC_TO_ASCII_STRICT = b"UACMGRSVTWYHKDBN"  # DNA_IUPAC (code 0 = 'U')


def _make_dna16() -> Alphabet:
    mapping = {
        "-": 0x0, ".": 0x0,
        "A": 0x1, "C": 0x2, "M": 0x3, "G": 0x4, "R": 0x5, "S": 0x6, "V": 0x7,
        "T": 0x8, "U": 0x8, "W": 0x9, "Y": 0xA, "H": 0xB, "K": 0xC, "D": 0xD,
        "B": 0xE, "N": 0xF,
    }
    from_ascii, valid = _lut(mapping, default=0xF)
    # complement = 4-bit reversal; gap (0) -> gap.
    comp = np.array([int(f"{i:04b}"[::-1], 2) for i in range(16)], dtype=np.uint8)
    return Alphabet(
        name="DNA16",
        size=16,
        bits_per_char=4,
        from_ascii=from_ascii,
        to_ascii=np.frombuffer(_IUPAC_TO_ASCII_16, dtype=np.uint8).copy(),
        to_complement=comp,
        valid_ascii=valid,
    )


def _make_dna_iupac() -> Alphabet:
    mapping = {
        "U": 0x0,
        "A": 0x1, "C": 0x2, "M": 0x3, "G": 0x4, "R": 0x5, "S": 0x6, "V": 0x7,
        "T": 0x8, "W": 0x9, "Y": 0xA, "H": 0xB, "K": 0xC, "D": 0xD, "B": 0xE,
        "N": 0xF,
    }
    from_ascii, valid = _lut(mapping, default=0xF)
    # strict IUPAC complement (alphabets.hpp:601-620): like DNA16 4-bit
    # reversal except U(0) -> A(1) and the letters containing T/U.
    comp = np.array(
        [1, 8, 4, 12, 2, 10, 6, 14, 1, 9, 5, 13, 3, 11, 7, 15], dtype=np.uint8
    )
    return Alphabet(
        name="DNA_IUPAC",
        size=16,
        bits_per_char=4,
        from_ascii=from_ascii,
        to_ascii=np.frombuffer(_IUPAC_TO_ASCII_STRICT, dtype=np.uint8).copy(),
        to_complement=comp,
        valid_ascii=valid,
    )


def _make_ascii() -> Alphabet:
    ident = np.arange(256, dtype=np.uint8)
    return Alphabet(
        name="ASCII",
        size=256,
        bits_per_char=8,
        from_ascii=ident.copy(),
        to_ascii=ident.copy(),
        to_complement=ident.copy(),
        valid_ascii=np.ones(256, dtype=bool),
    )


DNA = _make_dna()
RNA = _make_rna()
DNA6 = _make_dna6("DNA6", "T")
RNA6 = _make_dna6("RNA6", "U")
DNA5 = DNA6  # alias, alphabets.hpp:727-737
RNA5 = RNA6
DNA16 = _make_dna16()
DNA_IUPAC = _make_dna_iupac()
ASCII = _make_ascii()

_REGISTRY = {
    "DNA": DNA,
    "RNA": RNA,
    "DNA5": DNA5,
    "DNA6": DNA6,
    "RNA5": RNA5,
    "RNA6": RNA6,
    "DNA16": DNA16,
    "DNA_IUPAC": DNA_IUPAC,
    "ASCII": ASCII,
}


def by_name(name: str) -> Alphabet:
    return _REGISTRY[name.upper()]
