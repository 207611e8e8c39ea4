"""Test-case generation helper (counterpart of
``raft_tpu/util/itertools.py``)."""

from __future__ import annotations

import itertools
from typing import Any, Iterable, List


def product_of_lists(*lists: Iterable[Any]) -> List[tuple]:
    """Cartesian product of the lists, as a list of tuples."""
    return list(itertools.product(*lists))
