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


@pytest.mark.parametrize("kernel", ["extract", "runlength", "merge", "scan",
                                    "all"])
def test_kernel_argument_without_a_gpu(kernel, monkeypatch):
    """Every kernel name (and all) parses, with --variant; without a GPU the
    tool stops before building anything."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert sweep_variants.main(["--kernel", kernel, "--variant",
                                "committed"]) == 2


def test_unknown_kernel_is_refused():
    with pytest.raises(SystemExit):
        sweep_variants.main(["--kernel", "sort"])
