"""Batched linear assignment problem on the card (counterpart of
``raft_tpu/solver/linear_assignment.py``).

The auction algorithm (Bertsekas) with epsilon-scaling, the reference
package's. Each bidding round, for every lane of the batch at once, is

    values  = benefit - prices            (one [B, n, n] pass)
    best    = first maximum of each row, second = the maximum with that
              column masked (lax.top_k's order: a total order, ties to
              the lowest index)
    bids    = price[best] + (v1 - v2) + eps
    winners = per-object scatter-max of the bids, then a scatter-min of
              the bidders at that maximum (the lowest index wins)

in torch ops on the cost's device. The reference runs a ``vmap`` of a
``while_loop``: a lane whose condition turns false freezes while the
others run. Here only the unassigned persons of lanes with ``active =
any person unassigned & it < max_rounds`` bid, and ``it`` counts per
lane, so a lane that reaches ``max_rounds`` unassigned stops there and
reports non-convergence. The reference computes every person's values
and discards the assigned persons' bids; a round here gathers the
bidders alone (one host read of their count a round), which gives the
same bits at a cost that follows the bidders, and ends the phase when
there are none.

Accuracy contract (the auction's): the assignment's total cost is
within n·eps_final of the minimum; integral costs with eps_final < 1/n
are solved exactly. eps_final below 8 ulp of a lane's cost spread is
clamped there.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from raft_tpu_torch.core.resources import as_tensor

def _order_key(values: torch.Tensor) -> torch.Tensor:
    """Integer keys in the floats' total order (-0.0 below +0.0), the
    order ``lax.top_k`` ranks by."""
    ity = torch.int32 if values.dtype == torch.float32 else torch.int64
    bits = values.view(ity)
    return bits ^ ((bits >> (bits.element_size() * 8 - 1))
                   & torch.iinfo(ity).max)


def _round(benefit, prices, obj_of, person_of, it, eps, max_rounds) -> int:
    """One bidding round of every active lane, in place. ``benefit``
    [B, n, n] person x object payoff (maximization); ``prices``,
    ``obj_of`` (person -> object), ``person_of`` (object -> person)
    [B, n]; ``it`` [B] rounds run; ``eps`` [B]. Only the unassigned
    persons of active lanes bid, so they alone are gathered (one host
    read of their count). Returns that count: 0 when no lane is
    active."""
    bsz, n, _ = benefit.shape
    dev, dt = benefit.device, benefit.dtype
    active = (obj_of < 0).any(dim=1) & (it < max_rounds)
    lane, person = torch.nonzero((obj_of < 0) & active[:, None],
                                 as_tuple=True)
    if not lane.numel():
        return 0
    it += active.to(it.dtype)
    values = benefit[lane, person] - prices[lane]
    key = _order_key(values)
    best = torch.argmax(key, dim=1, keepdim=True)
    key.scatter_(1, best, torch.iinfo(key.dtype).min)
    second = torch.argmax(key, dim=1, keepdim=True)
    v1 = torch.gather(values, 1, best)[:, 0]
    v2 = torch.gather(values, 1, second)[:, 0]
    flat = lane * n + best[:, 0]
    bid = prices.view(-1)[flat] + (v1 - v2) + eps[lane]
    # per object: the highest bid, then the lowest bidder at it
    best_bid = torch.full((bsz * n,), -math.inf, dtype=dt, device=dev)
    best_bid.scatter_reduce_(0, flat, bid, "amax")
    winner = torch.full((bsz * n,), n, dtype=torch.int64, device=dev)
    winner.scatter_reduce_(0, flat, torch.where(bid == best_bid[flat],
                                                person, n), "amin")
    winner = winner.view(bsz, n)
    has_winner = winner < n
    # objects changing hands: their previous owners lose them; column n
    # takes the writes the reference drops
    evicted = has_winner & (person_of >= 0)
    buf = torch.cat([obj_of, obj_of[:, :1]], dim=1)
    buf.scatter_(1, torch.where(evicted, person_of.long(), n), -1)
    obj_ids = torch.arange(n, dtype=obj_of.dtype, device=dev)
    buf.scatter_(1, torch.where(has_winner, winner, n),
                 torch.where(has_winner, obj_ids, -1))
    obj_of.copy_(buf[:, :n])
    person_of.copy_(torch.where(has_winner, winner.to(person_of.dtype),
                                person_of))
    prices.copy_(torch.where(has_winner, best_bid.view(bsz, n), prices))
    return int(lane.numel())


def _phase(benefit, prices, obj_of, person_of, eps, max_rounds, stats):
    """Run one epsilon phase to completion on every lane. Returns the
    rounds run (the most any lane ran: a lane once done stays done)."""
    it = torch.zeros(benefit.shape[0], dtype=torch.int32,
                     device=benefit.device)
    rounds = 0
    while True:
        stats["syncs"] += 1
        if not _round(benefit, prices, obj_of, person_of, it, eps,
                      max_rounds):
            return rounds
        rounds += 1


def _num_phases(dtype) -> int:
    """Phases so the static schedule 0.5/5^k reaches the ulp floor."""
    floor = 8.0 * float(torch.finfo(dtype).eps)
    return max(1, math.ceil(math.log(0.5 / floor) / math.log(5.0))) + 1


def _solve_batch(cost, eps_final: float, n_phases: int, stats: dict):
    """Every epsilon phase for the whole [B, n, n] batch.

    Each lane is scaled to a unit cost spread (the auction is invariant
    to positive scaling), which keeps price increments above the dtype's
    ulp; a lane's final epsilon is max(eps_final / spread, 8 ulp).
    Returns (obj_of, person_of, prices back on the cost scale); -1 in
    obj_of marks a lane that did not converge."""
    bsz, n, _ = cost.shape
    dt, dev = cost.dtype, cost.device
    spread = cost.amax(dim=(1, 2)) - cost.amin(dim=(1, 2))
    degenerate = spread == 0
    bad = ~torch.isfinite(spread)
    one = torch.ones((), dtype=dt, device=dev)
    safe = torch.where(degenerate | bad, one, spread)
    # a NaN or inf lane bids on a neutral benefit and is forced to -1
    # after, so the caller's convergence check raises for it
    benefit = torch.where(bad[:, None, None], torch.zeros((), dtype=dt,
                                                          device=dev),
                          -cost / safe[:, None, None])
    ulp = torch.tensor(8.0 * float(torch.finfo(dt).eps), dtype=dt,
                       device=dev)
    eps_last = torch.maximum(torch.tensor(eps_final, dtype=dt, device=dev)
                             / safe, ulp)
    max_rounds = 50 * n * max(1, int(np.log2(n + 1)))
    schedule = (0.5 / 5.0 ** np.arange(n_phases)).astype(np.float32)

    prices = torch.zeros((bsz, n), dtype=dt, device=dev)
    obj_of = torch.full((bsz, n), -1, dtype=torch.int32, device=dev)
    person_of = torch.full((bsz, n), -1, dtype=torch.int32, device=dev)
    eps_prev = torch.full((bsz,), math.inf, dtype=dt, device=dev)
    for eps_k in schedule:
        eps_b = torch.maximum(torch.tensor(float(eps_k), dtype=dt,
                                           device=dev), eps_last)
        # a lane whose epsilon decreased restarts its assignment (scaling
        # keeps only the prices); a clamped lane keeps its converged one
        fresh = (eps_b < eps_prev)[:, None]
        obj_of.masked_fill_(fresh, -1)
        person_of.masked_fill_(fresh, -1)
        stats["rounds"].append(_phase(benefit, prices, obj_of, person_of,
                                      eps_b, max_rounds, stats))
        eps_prev = eps_b

    ident = torch.arange(n, dtype=torch.int32, device=dev)[None, :]
    obj_of = torch.where(degenerate[:, None], ident, obj_of)
    obj_of = torch.where(bad[:, None], -1, obj_of)
    person_of = torch.where(degenerate[:, None], ident, person_of)
    prices = torch.where(degenerate[:, None], torch.zeros((), dtype=dt,
                                                          device=dev),
                         prices * safe[:, None])
    return obj_of, person_of, prices


def _solve_many(cost, eps_final: float, strict: bool = True):
    """The batch's solve and its one convergence check.

    Returns (obj_of, person_of, prices, report). A lane left unassigned
    raises :class:`~raft_tpu_torch.core.guards.ConvergenceError` carrying
    the report; ``strict=False`` warns instead and returns it as -1.
    Records a ``solver.linear_assignment`` trace event with the rounds
    of each phase (the most any lane ran) and the host reads.""" 
    from raft_tpu_torch.core import logger, trace
    from raft_tpu_torch.core.guards import (ConvergenceError,
                                            ConvergenceReport)
    from raft_tpu_torch.runtime import limits

    limits.check_deadline("solver.linear_assignment")
    n = cost.shape[1]
    n_phases = _num_phases(cost.dtype)
    if n == 1:
        zero = torch.zeros(cost.shape[:1] + (1,), dtype=torch.int32,
                           device=cost.device)
        return zero, zero, torch.zeros_like(zero, dtype=cost.dtype), \
            ConvergenceReport(converged=True, n_iter=0, residual=0.0,
                              tol=float(eps_final))
    stats = {"rounds": [], "syncs": 0}
    obj_of, person_of, prices = _solve_batch(cost, float(eps_final),
                                             n_phases, stats)
    limits.check_deadline("solver.linear_assignment")
    report = ConvergenceReport(converged=True, n_iter=n_phases,
                               residual=0.0, tol=float(eps_final))
    lanes = (obj_of < 0).any(dim=1)
    stats["syncs"] += 1
    trace.record_event("solver.linear_assignment", batch=int(cost.shape[0]),
                       n=n, phases=n_phases, rounds=stats["rounds"],
                       syncs=stats["syncs"])
    if bool(lanes.any()):
        bad = torch.nonzero(lanes)[:, 0].cpu().tolist()
        report.converged = False
        report.residual = float(len(bad))
        report.detail = f"unconverged batch elements: {bad}"
        msg = ("auction LAP did not converge for batch element(s) "
               f"{bad} (persons left unassigned after the final "
               f"epsilon phase, eps_final={eps_final:g}); increase epsilon "
               "or check the cost matrix for NaN/inf")
        if strict:
            raise ConvergenceError(msg, report=report,
                                   op="solver.linear_assignment")
        logger.warn("solver.linear_assignment: %s (strict=False; "
                    "unassigned lanes returned as -1)", msg)
    return obj_of, person_of, prices, report


class LinearAssignmentProblem:
    """Batched LAP solver. :meth:`solve` takes cost matrices [batchsize,
    size, size] (or [size, size]) and computes row assignments (person
    -> object), column assignments (object -> person) and the primal and
    dual objectives, the whole batch at once on the cost's device (a
    non-tensor goes to the handle's, ``cuda:0`` by default)."""

    def __init__(self, res, size: int, batchsize: int = 1,
                 epsilon: float = 1e-6, strict: bool = True):
        self._res = res
        self._size = size
        self._batch = batchsize
        self._eps = float(epsilon)
        self._strict = bool(strict)
        self._row_assign = None
        self._col_assign = None
        self._row_duals = None
        self._col_duals = None
        self._costs = None
        self._report = None

    def solve(self, cost_matrix):
        cost = as_tensor(cost_matrix, self._res)
        if cost.ndim == 2:
            cost = cost[None, :, :]
        if tuple(cost.shape) != (self._batch, self._size, self._size):
            raise ValueError(
                f"expected cost shape {(self._batch, self._size, self._size)}"
                f", got {tuple(cost.shape)}")
        (self._row_assign, self._col_assign, self._col_duals,
         self._report) = _solve_many(cost, self._eps, strict=self._strict)
        # row duals: the slack left to each person at the final prices
        self._row_duals = (-cost - self._col_duals[:, None, :]).amax(dim=2)
        self._costs = cost
        return self._row_assign, self._col_assign

    @property
    def row_assignments(self):
        return self._row_assign

    @property
    def col_assignments(self):
        return self._col_assign

    @property
    def report(self):
        """The :class:`~raft_tpu_torch.core.guards.ConvergenceReport` of
        the last :meth:`solve` (None before the first)."""
        return self._report

    def get_primal_objective_value(self, batch_id: int = 0):
        """Sum of the costs along the assignment."""
        c = self._costs[batch_id]
        rows = torch.arange(self._size, device=c.device)
        return c[rows, self._row_assign[batch_id].long()].sum()

    def get_dual_objective_value(self, batch_id: int = 0):
        """sum(row duals) + sum(col duals), negated back to the
        minimization's scale; within n·eps of the primal at optimality."""
        return -(self._row_duals[batch_id].sum()
                 + self._col_duals[batch_id].sum())


def solve_linear_assignment(res, cost_matrix, epsilon: float = 1e-6,
                            strict: bool = True,
                            return_report: bool = False):
    """One-shot front end: ``(row_assignment, total_cost)``, with the
    :class:`~raft_tpu_torch.core.guards.ConvergenceReport` appended when
    ``return_report``. ``strict=False`` turns a convergence failure into
    a warning (unassigned rows come back as -1).

    >>> import torch
    >>> cost = torch.tensor([[4., 1., 3.], [2., 0., 5.], [3., 2., 2.]])
    >>> rows, total = solve_linear_assignment(None, cost)
    >>> rows.tolist(), float(total)
    ([1, 0, 2], 5.0)
    """
    cost = as_tensor(cost_matrix, res)
    squeeze = cost.ndim == 2
    if squeeze:
        cost = cost[None]
    lap = LinearAssignmentProblem(res, cost.shape[1], cost.shape[0],
                                  epsilon, strict=strict)
    rows, _ = lap.solve(cost)
    # an unassigned row (-1, strict=False) reads the last column, as a
    # negative index does in the reference
    cols = torch.remainder(rows.long(), cost.shape[2])
    totals = torch.gather(cost, 2, cols[:, :, None])[:, :, 0].sum(dim=1)
    if squeeze:
        rows, totals = rows[0], totals[0]
    if return_report:
        return rows, totals, lap.report
    return rows, totals
