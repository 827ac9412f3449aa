"""The port stands alone: no module of kmerind_tpu_torch/, no tool under
tools/ and not chip_smoke.py imports JAX or the JAX package (only the
parity tests import both)."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FILES = sorted([*(ROOT / "kmerind_tpu_torch").rglob("*.py"),
                *(ROOT / "tools").glob("*.py"), ROOT / "chip_smoke.py"])


def _imported(tree) -> set:
    """Top-level package of every import statement in a module."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_the_file_list_covers_the_port():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert {"chip_smoke.py", "kmerind_tpu_torch/debruijn/graph.py",
            "kmerind_tpu_torch/index/api.py",
            "kmerind_tpu_torch/parallel/mesh.py",
            "kmerind_tpu_torch/parallel/multihost.py",
            "kmerind_tpu_torch/bench/cli.py",
            "kmerind_tpu_torch/bench/micro.py",
            "kmerind_tpu_torch/utils/logging.py",
            "kmerind_tpu_torch/utils/profiling.py",
            "tools/profile_p4.py"} <= names


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_import(path):
    found = _imported(ast.parse(path.read_text(), str(path)))
    assert not found & {"jax", "jaxlib", "kmerind_tpu"}, found
