"""Run-layout stores, per-shard steps and the index API."""

from .api import (BimoleculeCountIndex, CountIndex, PositionIndex,
                  PositionQualityIndex)
from .sorted_api import (SortedCountIndex, SortedPositionIndex,
                         SortedPositionQualityIndex)
from .value_api import KmerValueIndex, SortedKmerValueIndex

__all__ = ["CountIndex", "BimoleculeCountIndex", "PositionIndex",
           "PositionQualityIndex", "KmerValueIndex", "SortedCountIndex",
           "SortedPositionIndex", "SortedPositionQualityIndex",
           "SortedKmerValueIndex"]
