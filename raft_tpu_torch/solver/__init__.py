"""Combinatorial solvers (counterpart of ``raft_tpu/solver``)."""

from raft_tpu_torch.solver.linear_assignment import (  # noqa: F401
    LinearAssignmentProblem,
    solve_linear_assignment,
)
