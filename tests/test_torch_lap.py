"""The auction LAP solver of the port against the reference package on
the same numpy cost batches made from a seed.

Exact: row and column assignments, prices (the column duals), row duals
and the convergence reports. The objective values are sums, which the
two packages may order differently: they compare within 1e-6 of the sum
of |cost| along the assignment (integral costs exactly). The reference
is imported in a fixture and compiles once per cost shape, so the card
test at the end runs where JAX is absent (``-m cuda --noconftest``).
"""

import types

import numpy as np
import pytest
import torch

from raft_tpu_torch import interop
from raft_tpu_torch.core import resources as tres
from raft_tpu_torch.core import trace
from raft_tpu_torch.core.guards import ConvergenceError
from raft_tpu_torch.solver import linear_assignment as tla

SEED = 16
OBJ_REL = 1e-6


@pytest.fixture(scope="module")
def ref():
    from raft_tpu.core.guards import ConvergenceError as RConvergenceError
    from raft_tpu.solver import linear_assignment

    return types.SimpleNamespace(la=linear_assignment,
                                 ConvergenceError=RConvergenceError)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _costs(kind, b, n, seed=SEED, dtype=np.float32):
    rng = np.random.default_rng(seed + 7 * n + b)
    if kind == "integral":
        return rng.integers(0, 1000, (b, n, n)).astype(dtype)
    if kind == "tied":
        # repeated columns and a row of equal costs: ties everywhere
        c = rng.integers(0, 5, (b, n, n)).astype(dtype)
        c[:, :, 1::2] = c[:, :, 0:-1:2]
        c[:, 0, :] = 2.0
        return c
    return rng.random((b, n, n), dtype=np.float64).astype(dtype)


def _solve_both(ref, cost, eps=1e-6, strict=True):
    lap = tla.LinearAssignmentProblem(None, cost.shape[1], cost.shape[0],
                                      eps, strict)
    rlap = ref.la.LinearAssignmentProblem(None, cost.shape[1],
                                          cost.shape[0], eps, strict)
    lap.solve(interop.lap_costs_from_numpy(cost, tres.device_resources(
        "cpu")))
    rlap.solve(cost)
    return lap, rlap


def _assert_same(lap, rlap):
    for mine, theirs in ((lap.row_assignments, rlap.row_assignments),
                         (lap.col_assignments, rlap.col_assignments),
                         (lap._col_duals, rlap._col_duals),
                         (lap._row_duals, rlap._row_duals)):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))
    for b in range(lap._batch):
        c = np.abs(np.asarray(rlap._costs[b]))
        scale = float(c[np.isfinite(c)].max(initial=1.0)) * lap._size
        for get in ("get_primal_objective_value",
                    "get_dual_objective_value"):
            np.testing.assert_allclose(
                float(getattr(lap, get)(b)),
                float(getattr(rlap, get)(b)), rtol=0, atol=OBJ_REL * scale,
                equal_nan=True)


@pytest.mark.parametrize("kind,b,n", [
    ("uniform", 1, 2), ("integral", 1, 8), ("uniform", 3, 16),
    ("tied", 2, 24), ("integral", 2, 33), ("uniform", 4, 64),
])
def test_assignments_and_prices_match(ref, kind, b, n):
    lap, rlap = _solve_both(ref, _costs(kind, b, n))
    _assert_same(lap, rlap)
    assert lap.report.converged and rlap.report.converged
    assert lap.report.n_iter == rlap.report.n_iter
    # a permutation on every lane
    rows = lap.row_assignments.numpy()
    assert (np.sort(rows, axis=1) == np.arange(n)).all()


def test_f64_costs_match(ref):
    cost = _costs("uniform", 2, 12, dtype=np.float64)
    lap, rlap = _solve_both(ref, cost, eps=1e-9)
    _assert_same(lap, rlap)
    assert lap._col_duals.dtype == torch.float64


def test_integral_costs_are_exact(ref):
    from scipy.optimize import linear_sum_assignment

    cost = _costs("integral", 1, 40)[0]
    rows, total = tla.solve_linear_assignment(None, torch.from_numpy(cost))
    rrows, rtotal = ref.la.solve_linear_assignment(None, cost)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(rrows))
    r, c = linear_sum_assignment(cost)
    assert float(total) == float(rtotal) == float(cost[r, c].sum())


def test_nan_and_constant_lanes(ref):
    cost = _costs("uniform", 4, 10)
    cost[1, 3, 4] = np.nan
    cost[2] = 5.0
    with pytest.raises(ref.ConvergenceError) as rerr:
        ref.la.solve_linear_assignment(None, cost)
    with pytest.raises(ConvergenceError) as err:
        tla.solve_linear_assignment(None, torch.from_numpy(cost))
    assert str(err.value) == str(rerr.value)
    assert err.value.report.detail == rerr.value.report.detail
    # strict=False: the NaN lane comes back as -1, the constant lane as
    # the identity, the others solved
    lap, rlap = _solve_both(ref, cost, strict=False)
    _assert_same(lap, rlap)
    assert (lap.row_assignments[1] == -1).all()
    assert lap.row_assignments[2].tolist() == list(range(10))
    assert not lap.report.converged and lap.report.residual == 1.0
    rows, totals, rep = tla.solve_linear_assignment(
        None, torch.from_numpy(cost), strict=False, return_report=True)
    rrows, rtotals, rrep = ref.la.solve_linear_assignment(
        None, cost, strict=False, return_report=True)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(rrows))
    # the unassigned lane's total reads the last column, as the
    # reference's negative take does
    np.testing.assert_allclose(totals.numpy(), np.asarray(rtotals), rtol=0,
                               atol=OBJ_REL * 10 * 5.0)
    assert rep.detail == rrep.detail


def test_single_person(ref):
    cost = np.array([[[3.5]], [[np.nan]]], np.float32)
    lap, rlap = _solve_both(ref, cost)
    _assert_same(lap, rlap)
    rows, total = tla.solve_linear_assignment(None, torch.tensor([[2.0]]))
    assert rows.tolist() == [0] and float(total) == 2.0


def test_a_stuck_lane_freezes_at_max_rounds(ref):
    """One phase with max_rounds = 3: a lane whose persons all want one
    object is still bidding after 3 rounds and freezes there, unassigned,
    while a lane that converges in one round keeps its result: the
    reference's vmapped while_loop, lane for lane."""
    import jax
    import jax.numpy as jnp

    n = 6
    easy = -np.eye(n, dtype=np.float32)          # person i wants object i
    hard = np.tile(np.linspace(1.0, 0.0, n, dtype=np.float32), (n, 1))
    benefit = np.stack([-easy, hard])
    eps = np.full(2, 0.01, np.float32)
    want = jax.vmap(ref.la._phase, in_axes=(0, 0, 0, 0, 0, None))(
        jnp.asarray(benefit), jnp.zeros((2, n), jnp.float32),
        jnp.full((2, n), -1, jnp.int32), jnp.full((2, n), -1, jnp.int32),
        jnp.asarray(eps), 3)
    prices = torch.zeros(2, n)
    obj_of = torch.full((2, n), -1, dtype=torch.int32)
    person_of = torch.full((2, n), -1, dtype=torch.int32)
    stats = {"syncs": 0}
    rounds = tla._phase(torch.from_numpy(benefit), prices, obj_of,
                        person_of, torch.from_numpy(eps), 3, stats)
    for got, w in zip((prices, obj_of, person_of), want):
        np.testing.assert_array_equal(got.numpy(), np.asarray(w))
    assert rounds == 3 and stats["syncs"] == 4
    assert (obj_of[0] >= 0).all() and (obj_of[1] < 0).any()


def test_rounds_and_reads_are_reported():
    """The trace event: the rounds of each of the 10 f32 phases and one
    host read a round, one more a phase, one for the final check."""
    cost = torch.from_numpy(_costs("uniform", 3, 20))
    trace.clear_events()
    tla.LinearAssignmentProblem(None, 20, 3).solve(cost)
    (event,) = trace.events("solver.linear_assignment")
    assert len(event["rounds"]) == event["phases"] == 10
    assert all(r > 0 for r in event["rounds"])
    assert event["syncs"] == sum(event["rounds"]) + event["phases"] + 1
    assert (event["batch"], event["n"]) == (3, 20)


def test_deadline_and_device_rules():
    from raft_tpu_torch.runtime import limits

    cost = torch.from_numpy(_costs("uniform", 1, 4)[0])
    with limits.deadline_scope(1e-9):
        with pytest.raises(limits.DeadlineExceededError):
            tla.solve_linear_assignment(None, cost)
    with pytest.raises(ValueError, match="expected cost shape"):
        tla.LinearAssignmentProblem(None, 5).solve(cost)
    if not torch.cuda.is_available():
        with pytest.raises(tres.DeviceUnavailableError):
            tla.solve_linear_assignment(None, cost.numpy())


@pytest.mark.cuda
def test_lap_on_card_equals_the_cpu(card):
    for kind, b, n in (("integral", 1, 128), ("uniform", 8, 64),
                       ("tied", 2, 48)):
        cost = torch.from_numpy(_costs(kind, b, n))
        got = tla.LinearAssignmentProblem(None, n, b)
        got.solve(cost.to(card))
        want = tla.LinearAssignmentProblem(None, n, b)
        want.solve(cost)
        assert torch.equal(got.row_assignments.cpu(), want.row_assignments)
        assert torch.equal(got._col_duals.cpu(), want._col_duals)
        assert torch.equal(got._row_duals.cpu(), want._row_duals)
