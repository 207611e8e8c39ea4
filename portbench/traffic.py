"""The one generator every traffic mix goes through.

A mix is a data file in ``traffic/`` (``<name>.json``). Its ``loop`` is
``"closed"``: one caller, back to back, each call waiting for its
answer. ``input`` is ``"queries"`` (calls of ``rows_per_call`` rows of
the run's ``query_set``, the blocks walking the set and wrapping) or
``"base"`` (each call takes the whole database, as a fit does).
"""

from __future__ import annotations

import numpy as np


def closed_rows(traffic: dict, call: int) -> np.ndarray:
    """The query-set rows of closed-loop call ``call``."""
    n = int(traffic["query_set"])
    r = int(traffic["rows_per_call"])
    return (call * r + np.arange(r)) % n
