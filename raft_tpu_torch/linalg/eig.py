"""Symmetric eigensolvers (counterpart of ``raft_tpu/linalg/eig.py``).

``eig_dc`` is ``torch.linalg.eigh`` (cuSOLVER's syevd on the card).
``eig_jacobi`` is the reference's cyclic Jacobi solver with its
tol/sweeps semantics: each sweep runs the round-robin schedule's n - 1
rounds of n/2 disjoint rotations (the odd n padded with a decoupled
slot), until the off-diagonal norm is at most ``tol · ||A||_F`` or
``sweeps`` sweeps have run. A round's rotations are applied in the
reference's form (:func:`_round_dense`): one dense orthogonal factor G
and the products ``Gᵀ A G`` and ``V G``, O(n³) a round. Applying them
as paired row and column updates, O(n²) a round, was slower on an H100
at n = 1024, where both are bound by the host's launches (``PERF.md``).

``eig_sel`` slices ``eig_dc`` at small n; at n >= 512 with k <= n/3
(f32) it runs the port's dense-operator thick-restart Lanczos for the
requested pairs only, checks their residuals and Gram matrix, and
falls back to the exact slice when they fail, as the reference does.

Not ported yet (ROADMAP.md, queue A item 13b): ``eig_jacobi``'s guard
modes 'check'/'recover' (the f64 escalation) and its convergence
metrics (``obs.record_convergence``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from raft_tpu_torch.core import logger
from raft_tpu_torch.core.operators import exact_sqrt
from raft_tpu_torch.core.resources import as_tensor
from raft_tpu_torch.util.precision import scope, with_matmul_precision

EigVecUsage = ("OVERWRITE_INPUT", "COPY_INPUT")

def eig_dc(res, matrix):
    """Eigendecomposition of a symmetric matrix: (eigenvalues ascending,
    eigenvectors as columns)."""
    w, v = torch.linalg.eigh(as_tensor(matrix, res))
    return w, v


@functools.lru_cache(maxsize=64)
def _round_robin_pairs(n: int) -> np.ndarray:
    """Circle-method tournament schedule: n-1 rounds of n/2 disjoint
    pairs covering every (p, q) once. n must be even. [n-1, n/2, 2]."""
    assert n % 2 == 0
    players = list(range(n))
    rounds = []
    for _ in range(n - 1):
        pairs = [(players[i], players[n - 1 - i]) for i in range(n // 2)]
        rounds.append([(min(p, q), max(p, q)) for p, q in pairs])
        players = [players[0]] + [players[-1]] + players[1:-1]
    return np.asarray(rounds, dtype=np.int32)


def _angles(a, p, q):
    """(c, s) of each pair's rotation (Golub & Van Loan 8.4), the
    identity where |a_pq| is tiny; sign(0) = +1, so equal diagonal
    entries still rotate by 45 degrees."""
    app, aqq, apq = a[p, p], a[q, q], a[p, q]
    safe = torch.abs(apq) > torch.finfo(a.dtype).tiny * 16
    tau = (aqq - app) / torch.where(safe, 2.0 * apq, 1.0)
    sgn = torch.where(tau >= 0, 1.0, -1.0).to(a.dtype)
    t = sgn / (torch.abs(tau) + exact_sqrt(1.0 + tau * tau))
    c = 1.0 / exact_sqrt(1.0 + t * t)
    return torch.where(safe, c, 1.0), torch.where(safe, t * c, 0.0)


def _round_dense(m, p, q, n: int):
    """The reference's form: one dense orthogonal factor G for the round,
    A <- Gᵀ A G and V <- V G."""
    a, v = m[:n], m[n:]
    c, s = _angles(a, p, q)
    g = torch.eye(n, dtype=a.dtype, device=a.device)
    g[p, p] = c
    g[q, q] = c
    g[p, q] = s
    g[q, p] = -s
    return torch.cat([g.T @ a @ g, v @ g])


def _off_norm(a):
    return exact_sqrt(torch.clamp_min(
        torch.sum(a * a) - torch.sum(torch.diagonal(a) ** 2), 0.0))


def _jacobi_sweeps(a, pairs, tol: float, max_sweeps: int):
    """Cyclic Jacobi until off(A) <= tol·||A||_F or ``max_sweeps``
    sweeps: ``(diag, V, sweeps, off, ||A||_F)``, one host sync a sweep.
    A and V are held stacked, [A; V]."""
    n = a.shape[0]
    norm = torch.linalg.norm(a)
    m = torch.cat([a, torch.eye(n, dtype=a.dtype, device=a.device)])
    off = torch.full((), float("inf"), dtype=a.dtype, device=a.device)
    rounds = [(r[:, 0], r[:, 1]) for r in pairs.unbind(0)]
    i = 0
    while i < max_sweeps and bool(off > tol * norm):
        for p, q in rounds:
            m = _round_dense(m, p, q, n)
        off = _off_norm(m[:n])
        i += 1
    return torch.diagonal(m[:n]), m[n:], i, off, norm


@with_matmul_precision
def eig_jacobi(res, matrix, tol: float = 1e-7, sweeps: int = 15,
               strict: bool = False, return_report: bool = False,
               guard_mode=None):
    """Jacobi eigensolver: (eigenvalues ascending, eigenvectors as
    columns), and the :class:`ConvergenceReport` with
    ``return_report=True``. ``tol`` bounds the off-diagonal Frobenius
    norm relative to ||A||_F, ``sweeps`` the cyclic sweeps. Reaching the
    sweep limit unconverged raises :class:`ConvergenceError` with
    ``strict=True``, else warns. Complex (Hermitian) input goes to
    ``eig_dc``."""
    from raft_tpu_torch.core.guards import (ConvergenceError,
                                            ConvergenceReport,
                                            resolve_guard_mode)
    from raft_tpu_torch.runtime import limits

    def finish(w, v, report):
        if return_report:
            return w, v, report
        return w, v

    a = as_tensor(matrix, res)
    mode = resolve_guard_mode(guard_mode)
    # the sweeps are one solve between two deadline polls, as the
    # reference's one device launch
    limits.check_deadline("linalg.eig_jacobi")
    if a.is_complex():
        w, v = eig_dc(res, a)
        return finish(w, v, ConvergenceReport(
            converged=True, n_iter=0, residual=0.0, tol=float(tol),
            detail="complex input: exact eig_dc path"))
    n = a.shape[0]
    if n <= 1:
        return finish(torch.diagonal(a),
                      torch.eye(n, dtype=a.dtype, device=a.device),
                      ConvergenceReport(converged=True, n_iter=0,
                                        residual=0.0, tol=float(tol)))
    dtype = a.dtype if a.dtype in (torch.float32, torch.float64) \
        else torch.float32
    a = a.to(dtype)
    np_ = n + (n % 2)
    ap = a
    if np_ != n:                       # pad with a decoupled diagonal slot
        ap = torch.nn.functional.pad(a, (0, 1, 0, 1))
    pairs = torch.as_tensor(_round_robin_pairs(np_), device=a.device).long()
    w, v, n_sweeps, off, norm = _jacobi_sweeps(ap, pairs, tol, sweeps)
    # the padded slot stays decoupled (every rotation touching it sees a
    # zero off-diagonal: the identity), so dropping row/col n is exact
    w, v = w[:n], v[:n, :n]
    limits.check_deadline("linalg.eig_jacobi")
    if mode != "off" or strict or return_report:
        off_h, norm_h = float(off), float(norm)
        report = ConvergenceReport(
            converged=off_h <= tol * norm_h, n_iter=int(n_sweeps),
            residual=off_h / norm_h if norm_h > 0 else 0.0,
            tol=float(tol))
        if not report.converged:
            if strict:
                raise ConvergenceError(
                    f"eig_jacobi: sweep limit {sweeps} reached with "
                    f"off-diagonal residual {report.residual:.3e} > tol "
                    f"{tol:.3e} (syevj info=n+1 class; strict=True)",
                    report=report, op="linalg.eig_jacobi")
            logger.warn(
                "eig_jacobi: sweep limit %d hit (residual %.3e > tol "
                "%.3e); returning unconverged decomposition", sweeps,
                report.residual, tol)
    else:
        report = ConvergenceReport(
            converged=True, n_iter=-1, residual=float("nan"),
            tol=float(tol), detail="not polled (guard off)")
    order = torch.argsort(w)
    return finish(w[order], v[:, order], report)


# Above this size (and for small-enough subsets) eig_sel runs the
# dense-operator thick-restart Lanczos instead of slicing the full
# decomposition, as the reference does.
_EIG_SEL_ITERATIVE_MIN_N = 512


def _eig_dc_slice(res, m, n_eig_vals: int, largest: bool):
    w, v = eig_dc(res, m)
    if largest:
        return w[-n_eig_vals:], v[:, -n_eig_vals:]
    return w[:n_eig_vals], v[:, :n_eig_vals]


def eig_sel(res, matrix, n_eig_vals: int, largest: bool = True,
            tol: float = 1e-6, exact=None):
    """The ``n_eig_vals`` largest (or smallest) eigenpairs, eigenvalues
    ascending within the selection, vectors as columns.

    ``exact``: None (auto) runs the iterative subset solver for f32
    matrices with n >= 512 and k <= n/3, else the exact ``eig_dc``
    slice; True always slices; False runs the iterative solver wherever
    it applies (f32, k <= n/2). Every iterative result is verified (each
    pair's residual within ``max(10 tol, sqrt(eps))`` of the operator's
    scale, the vectors' Gram matrix within 1e-3 of the identity), and one
    that fails falls back to the exact slice with a warning."""
    m = as_tensor(matrix, res)
    n = m.shape[0]
    k = n_eig_vals
    if not 0 < k <= n:
        raise ValueError(f"need 0 < n_eig_vals <= n, got {k} vs {n}")
    is_f32 = m.dtype == torch.float32
    want_iter = k < n and is_f32 and (
        (exact is False and k <= n // 2)
        or (exact is None and n >= _EIG_SEL_ITERATIVE_MIN_N
            and k <= n // 3))
    if want_iter:
        from raft_tpu_torch.sparse.solver.lanczos import (
            LanczosConfig, lanczos_compute_eigenpairs)

        # a few extra pairs give a boundary cluster room to surface all
        # its copies before the selection cuts
        k_solve = min(k + 4, n - 1)
        cfg = LanczosConfig(n_components=k_solve, max_iterations=200,
                            tolerance=tol,
                            which="LA" if largest else "SA")
        w, v = lanczos_compute_eigenpairs(res, m, cfg)
        order = torch.argsort(w)
        sel = order[-k:] if largest else order[:k]
        w, v = w[sel], v[:, sel]
        with scope("highest"):
            resid = torch.linalg.vector_norm(m @ v - v * w[None, :], dim=0)
            gram = v.T @ v
        w_h = w.double().cpu().numpy()
        resid_h = resid.double().cpu().numpy()
        gram_h = gram.double().cpu().numpy()
        # a lower bound of ||A||_2 keeps smallest-pair queries near zero
        # from demanding absolute accuracy an f32 matvec cannot give
        scale = max(float(np.abs(w_h).max(initial=0.0)),
                    float(torch.linalg.norm(m)) / float(np.sqrt(n)),
                    float(np.finfo(np.float32).tiny))
        sqrt_eps = float(np.sqrt(np.finfo(np.float32).eps))
        resid_ok = resid_h.max(initial=0.0) <= max(10.0 * tol,
                                                   sqrt_eps) * scale
        offdiag = float(np.abs(gram_h - np.eye(k)).max()) if k > 1 else 0.0
        if resid_ok and offdiag < 1e-3:
            return w, v
        logger.warn(
            "eig_sel: iterative subset failed verification (max residual "
            "%.3e, max Gram offdiag %.3e, scale %.3e) — falling back to "
            "the exact eig_dc slice", float(resid_h.max(initial=0.0)),
            offdiag, scale)
    return _eig_dc_slice(res, m, k, largest)
