"""tools/ab_trees.py: turns alternate A B B A, so drift over a call weighs
on both checkouts alike; without a GPU it refuses to time anything."""

import pathlib
import sys

import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                       / "tools"))

import ab_trees  # noqa: E402


@pytest.mark.parametrize("pairs,want", [
    (1, "ABBA"), (2, "ABBAABBA"), (0, "")])
def test_turn_order(pairs, want):
    assert "".join(ab_trees.turn_order(pairs)) == want


def test_needs_two_trees():
    with pytest.raises(SystemExit):
        ab_trees.main(["only_one"])


def test_no_gpu_no_times(monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ab_trees.main(["a", "b"]) == 2
    assert "no CUDA device" in capsys.readouterr().err
