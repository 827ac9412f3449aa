"""Phase timers and memory marks (`PhaseTimer`, `MemUsage`), sharded
checkpoints (`save_index`, `load_index`), logging and profiling."""

from .timers import MemUsage, PhaseTimer

__all__ = ["PhaseTimer", "MemUsage", "save_index", "load_index"]


def __getattr__(name):
    # the checkpoint module imports the index modules, which import this
    # package's timers: load it on first use
    if name in ("save_index", "load_index"):
        from . import checkpoint
        return getattr(checkpoint, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
