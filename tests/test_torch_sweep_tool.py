"""tools/sweep_variants.py: every variant's substitutions apply exactly
once to the committed CUDA source, and each variant differs from it."""

import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))

import sweep_variants  # noqa: E402

CSRC = ROOT / "kmerind_tpu_torch" / "ops" / "csrc"


@pytest.mark.parametrize("kname,variant", [
    (k, v) for k, (_, vs) in sweep_variants.VARIANTS.items() for v in vs])
def test_variant_applies_to_the_committed_source(kname, variant):
    src, variants = sweep_variants.VARIANTS[kname]
    text = (CSRC / src).read_text()
    got = sweep_variants.variant_source(text, variants[variant])
    assert (got == text) == (variant == "committed")


def test_substitution_must_match_once():
    with pytest.raises(ValueError):
        sweep_variants.variant_source("a a", [("a", "b")])
    with pytest.raises(ValueError):
        sweep_variants.variant_source("a", [("c", "b")])
