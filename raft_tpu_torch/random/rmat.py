"""R-MAT (stochastic Kronecker) edge generator (counterpart of
``raft_tpu/random/rmat.py``).

Every edge walks ``max(r_scale, c_scale)`` levels; at each level one
uniform draw picks a quadrant of the (a, b, c, d) table and appends one
bit to the source and one to the destination. All edges advance a level
at a time as tensor ops on the handle's device. The draws come from the
handle's ``RngState`` through a ``torch.Generator``, so the contract is
the reference's distribution, shape, dtype and range, not its bits.
"""

from __future__ import annotations

import torch

# the module, not its names: core.resources imports this package
from raft_tpu_torch.core import resources
from raft_tpu_torch.random.rng_state import RngState

__all__ = ["rmat_rectangular_gen"]


def rmat_rectangular_gen(res, state: RngState, r_scale: int, c_scale: int,
                         n_edges: int, theta=None, a: float = 0.57,
                         b: float = 0.19, c: float = 0.19,
                         dtype=torch.int32):
    """``n_edges`` edges of a 2^r_scale x 2^c_scale R-MAT graph on the
    handle's device (``cuda:0`` by default): ``(src [n_edges],
    dst [n_edges])``.

    ``theta`` is a per-level [max_scale, 4] probability table, or None for
    the scalar (a, b, c, 1 - a - b - c) at every level. Past a
    dimension's scale its bit is dropped, without renormalizing, as in
    the reference."""
    dev = resources.default_resources(res).device
    max_scale = max(r_scale, c_scale)
    if theta is None:
        theta = torch.tensor([[a, b, c, 1.0 - (a + b + c)]],
                             dtype=torch.float32).repeat(max_scale, 1)
    else:
        theta = torch.as_tensor(theta, dtype=torch.float32).reshape(
            max_scale, 4)
    cdf = torch.cumsum(theta[:, :3], dim=1).to(dev)      # a, a+b, a+b+c
    carry = (torch.int64 if torch.tensor([], dtype=dtype).element_size() > 4
             else torch.int32)
    if max_scale > 31 and carry == torch.int32:
        raise ValueError("r_scale/c_scale > 31 requires an int64 dtype")
    u = torch.rand((max_scale, n_edges), generator=state.next_key(dev),
                   dtype=torch.float32, device=dev)
    src = torch.zeros(n_edges, dtype=carry, device=dev)
    dst = torch.zeros(n_edges, dtype=carry, device=dev)
    for lvl in range(max_scale):
        # quadrant 0 = a (0, 0), 1 = b (0, 1), 2 = c (1, 0), 3 = d (1, 1)
        q = (u[lvl, :, None] >= cdf[lvl]).sum(1).to(carry)
        if lvl < r_scale:
            src = (src << 1) | (q >> 1)
        if lvl < c_scale:
            dst = (dst << 1) | (q & 1)
    return src.to(dtype), dst.to(dtype)
