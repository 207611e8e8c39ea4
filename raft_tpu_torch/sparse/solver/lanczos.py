"""Thick-restart Lanczos eigensolver on one device (counterpart of the
single-device half of ``raft_tpu/sparse/solver/lanczos.py``).

The structure is the reference's: a host-driven restart loop around the
Krylov extension on the device, with the small ncv x ncv Ritz problem
solved on the host in float64 numpy. The extension's hot operation is
the SpMV, through ``sparse.linalg.spmv``'s CUDA kernel
(``csrc/csr_spmv.cu``) for a CSR operand and ``torch.matmul`` for a dense
one; the Gram-Schmidt passes are matrix-vector products with TF32 off
(``util.precision``). The reference runs an extension's ncv − j_start
steps as one device program; here it is a Python loop of device work,
with one host sync a step for the breakdown test.

Same start vector as the reference: ``np.random.default_rng(seed)``.
The breakdown restart draws its direction from a ``torch.Generator``
seeded with the reference's key integer, so after a breakdown the two
packages' bits differ (ROADMAP.md, queue C: "RNG streams differ").

A zero or non-finite ``v0`` raises :class:`IllConditionedError`; the
reference raises it only under its ``check``/``recover`` guard modes,
which the port does not have (ROADMAP.md, queue C).

Not ported yet: ``sync_every > 1`` (the reference's compiled restart
chunks; a CUDA-graph capture with queue A item 13), ``eigsh_mnmg`` and
its checkpoints (item 7), deadlines and obs events (item 13).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.core.guards import (ConvergenceError, ConvergenceReport,
                                        IllConditionedError)
from raft_tpu_torch.core.resources import as_tensor
from raft_tpu_torch.core.sparse_types import COOMatrix, CSRMatrix
from raft_tpu_torch.sparse import convert, grid_spmv, linalg, op
from raft_tpu_torch.util.input_validation import resolve_sync_every
from raft_tpu_torch.util.precision import with_matmul_precision

__all__ = ["LanczosConfig", "lanczos_compute_eigenpairs", "eigsh",
           "eigsh_mnmg"]


@dataclasses.dataclass
class LanczosConfig:
    """The reference's ``LanczosConfig``. ``strict`` turns the
    exhausted-budget warning into :class:`ConvergenceError`."""
    n_components: int
    max_iterations: int = 1000
    ncv: int = 0          # 0 -> min(n, max(2*k + 1, 20))
    tolerance: float = 1e-7
    which: str = "SA"     # LA | LM | SA | SM
    seed: int = 42
    strict: bool = False


def _orthogonalize(v, basis):
    """One Gram-Schmidt pass against the rows of ``basis``."""
    coeffs = basis @ v
    return v - basis.T @ coeffs, coeffs


def _lanczos_step(matvec, basis, v, j: int, scale):
    """Lanczos step j on the device: writes ``v`` into ``basis[j]`` (in
    place), applies the operator and orthogonalizes twice. Returns
    ``(w, alpha, beta, scale, bad)``: the residual, the tridiagonal
    entries, the running operator scale (max ‖A·v‖) and the breakdown
    flag ``beta < √eps · scale``, all still on the device."""
    basis[j] = v
    w = matvec(v)
    scale = torch.maximum(scale, torch.linalg.vector_norm(w))
    w, c1 = _orthogonalize(w, basis)
    w, c2 = _orthogonalize(w, basis)
    alpha = c1[j] + c2[j]
    b = torch.linalg.vector_norm(w)
    fi = torch.finfo(basis.dtype)
    tol_b = fi.eps ** 0.5 * torch.clamp_min(scale, fi.tiny * 1e4)
    return w, alpha, b, scale, b < tol_b


def _extend_device(matvec, basis, v, seed: int, j_start: int, ncv: int):
    """Grow Krylov rows ``[j_start, ncv)``. Returns ``(basis, ab [2, ncv],
    breakdown [ncv] bool, v_next)`` on the device: ``ab[:, j]`` are step
    j's (alpha, beta), ``breakdown[j]`` flags a residual below the
    relative threshold, after which the step continues from a random
    direction orthogonal to the basis (drawn from a generator seeded with
    ``seed``), as the reference does."""
    dev, dtype = basis.device, basis.dtype
    alphas = torch.zeros(ncv, dtype=dtype, device=dev)
    betas = torch.zeros(ncv, dtype=dtype, device=dev)
    brk = torch.zeros(ncv, dtype=torch.bool, device=dev)
    scale = torch.zeros((), dtype=dtype, device=dev)
    gen = None
    for j in range(j_start, ncv):
        w, alpha, b, scale, bad = _lanczos_step(matvec, basis, v, j, scale)
        b_div = b
        if bool(bad):                               # the host sync a step
            if gen is None:
                gen = torch.Generator(device=dev).manual_seed(seed)
            w = torch.randn(basis.shape[1], generator=gen, dtype=dtype,
                            device=dev)
            w, _ = _orthogonalize(w, basis)
            w, _ = _orthogonalize(w, basis)
            b_div = torch.linalg.vector_norm(w)
        alphas[j] = alpha
        betas[j] = b                                # pre-recovery coupling
        brk[j] = bad
        v = w / b_div
    return basis, torch.stack([alphas, betas]), brk, v


def _resolve_sync_every(sync_every: Optional[int]) -> int:
    n = resolve_sync_every(sync_every)
    if n > 1:
        raise NotImplementedError(
            "lanczos: sync_every > 1 (restart chunks as one device program) "
            "is not ported yet; it becomes a CUDA-graph capture with the "
            "runtime port (ROADMAP.md, queue A item 13). sync_every=1 is "
            "the same algorithm.")
    return n


@with_matmul_precision
def lanczos_compute_eigenpairs(res, a, config: LanczosConfig,
                               v0=None, rank1=None,
                               return_report: bool = False,
                               sync_every: Optional[int] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k eigenpairs of a symmetric operator: a CSRMatrix or COOMatrix, or
    a dense [n, n] matrix (a non-tensor one goes to the handle's device).

    ``rank1 = (u, w, alpha)`` solves for A + alpha·u·wᵀ instead, applied
    matrix-free (the modularity matrix's form).

    Returns ``(eigenvalues [k], eigenvectors [n, k])``, ascending; with
    ``return_report=True`` also the :class:`ConvergenceReport`."""
    if isinstance(a, COOMatrix):
        a = convert.sorted_coo_to_csr(op.coo_sort(a))
    w, v, report = _eigsh_csr(a, config, v0, rank1=rank1,
                              sync_every=sync_every, res=res)
    if return_report:
        return w, v, report
    return w, v


@with_matmul_precision
def eigsh(a, k: int = 6, which: str = "SA", v0=None, ncv: int = 0,
          maxiter: int = 1000, tol: float = 1e-7, seed: int = 42,
          res=None, strict: bool = False, return_report: bool = False,
          sync_every: Optional[int] = None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """scipy-shaped front end. ``strict=True`` raises
    :class:`ConvergenceError` when ``maxiter`` restarts pass unconverged;
    ``return_report=True`` appends the report."""
    if not isinstance(a, (CSRMatrix, COOMatrix)):
        a = as_tensor(a, res)
        if a.dim() != 2 or a.shape[0] != a.shape[1]:
            raise ValueError(f"eigsh: A must be square, got "
                             f"{tuple(a.shape)}")
    cfg = LanczosConfig(n_components=k, max_iterations=maxiter, ncv=ncv,
                        tolerance=tol, which=which.upper(), seed=seed,
                        strict=strict)
    return lanczos_compute_eigenpairs(res, a, cfg, v0,
                                      return_report=return_report,
                                      sync_every=sync_every)


def eigsh_mnmg(*args, **kwargs):
    raise NotImplementedError(
        "eigsh_mnmg (row-partitioned Lanczos, its checkpoints and elastic "
        "resume) needs the comms port (ROADMAP.md, queue A item 7)")


def _matvec(a, rank1, dtype, device):
    """The operator: the CSR SpMV kernel or a dense matmul, plus the
    rank-1 term."""
    if isinstance(a, CSRMatrix):
        if a.data.dtype != dtype:
            a = CSRMatrix(a.indptr, a.indices, a.data.to(dtype), a.shape)
        plan = linalg._cached_plan(a)

        def base(v):
            return grid_spmv.spmv(plan, v)
    else:
        def base(v):
            return a @ v
    if rank1 is None:
        return base
    u, wv = (torch.as_tensor(x, device=device).to(dtype) for x in rank1[:2])
    alpha = torch.as_tensor(rank1[2], dtype=dtype, device=device)

    def with_rank1(v):
        return base(v) + alpha * u * torch.dot(wv, v)
    return with_rank1


def _eigsh_csr(csr, cfg: LanczosConfig, v0, rank1=None,
               sync_every: Optional[int] = None, res=None) -> Tuple:
    """The thick-restart driver; ``csr`` may be a dense symmetric matrix,
    which runs the same loop on a matmul."""
    dense = not isinstance(csr, CSRMatrix)
    if dense:
        csr = as_tensor(csr, res).to(torch.float32)
    n = csr.shape[0]
    k = cfg.n_components
    if k <= 0 or k >= n:
        raise ValueError(f"need 0 < n_components < n, got {k} vs {n}")
    if cfg.max_iterations < 1:
        raise ValueError(
            f"max_iterations must be >= 1, got {cfg.max_iterations}")
    ncv = cfg.ncv if cfg.ncv else min(n, max(2 * k + 1, 20))
    ncv = min(max(ncv, k + 2), n)
    which = cfg.which
    if which not in ("LA", "LM", "SA", "SM"):
        raise ValueError(f"which must be LA|LM|SA|SM, got {which}")
    _resolve_sync_every(sync_every)

    dtype = torch.float32
    device = csr.device
    matvec = _matvec(csr, rank1, dtype, device)
    if v0 is None:
        rng = np.random.default_rng(cfg.seed)
        v = torch.as_tensor(rng.standard_normal(n), device=device).to(dtype)
    else:
        v = torch.as_tensor(v0, device=device).to(dtype)
    nv = float(torch.linalg.vector_norm(v))
    if not nv > 0 or not np.isfinite(nv):
        raise IllConditionedError(
            f"eigsh: starting vector v0 has norm {nv!r}; cannot normalize "
            "a zero or non-finite direction", op="sparse.solver.eigsh")
    v = v / nv

    basis = torch.zeros((ncv, n), dtype=dtype, device=device)
    t = np.zeros((ncv, ncv), dtype=np.float64)       # projected matrix
    stats = {"breakdowns": 0}

    def extend(j_start: int, basis, t, v, it: int):
        """Steps ``[j_start, ncv)`` on the device, then one fetch of the
        tridiagonal entries into t."""
        basis, ab, brk, v = _extend_device(
            matvec, basis, v, cfg.seed + 7919 * (it + 1) + j_start,
            j_start, ncv)
        ab_h = ab.cpu().numpy().astype(np.float64)
        brk_h = brk.cpu().numpy()
        stats["breakdowns"] += int(brk_h[j_start:].sum())
        for j in range(j_start, ncv):
            t[j, j] = ab_h[0, j]
            if j + 1 < ncv:
                t[j, j + 1] = t[j + 1, j] = ab_h[1, j]
        # exact invariant subspace at the last step: no outside coupling
        beta_last = 0.0 if brk_h[ncv - 1] else float(ab_h[1, ncv - 1])
        return basis, t, beta_last, v

    return _restart_loop(extend, basis, t, v, cfg, k, ncv, which, dtype,
                         stats=stats)


def _np_ritz_order(evals, which: str):
    """Ritz selection order per ``which`` (magnitude for SM/LM)."""
    if which == "LM":
        return np.argsort(-np.abs(evals))
    if which == "SM":
        return np.argsort(np.abs(evals))
    if which == "LA":
        return np.argsort(-evals)
    return np.argsort(evals)


def _ritz(t, beta_last, which: str, k: int):
    """Host f64 Ritz problem: kept values, their vectors [ncv, k] and
    residuals."""
    evals, evecs = np.linalg.eigh(t)
    keep = _np_ritz_order(evals, which)[:k]
    s = evecs[:, keep]
    return evals[keep], s, np.abs(beta_last * s[-1, :])


def _finalize_ritz(basis, t, beta_last, n_iter, cfg, k, which, dtype,
                   stats=None):
    """Solve the projected problem, test convergence, back-transform the
    kept pairs and build the report (warn, or raise under ``strict``)."""
    ritz_vals, s, residuals = _ritz(t, beta_last, which, k)
    converged = float(residuals.max()) < cfg.tolerance
    report = ConvergenceReport(
        converged=converged, n_iter=n_iter,
        residual=float(residuals.max()), tol=float(cfg.tolerance),
        breakdowns=0 if stats is None else int(stats.get("breakdowns", 0)))
    if not converged:
        if cfg.strict:
            raise ConvergenceError(
                f"lanczos: max_iterations={cfg.max_iterations} "
                f"reached with residual {report.residual:.3e} > "
                f"tol {cfg.tolerance:.3e} (strict=True)",
                report=report, op="sparse.solver.lanczos")
        warnings.warn(
            f"lanczos: max_iterations={cfg.max_iterations} reached with "
            f"residual {report.residual:.3e} > tol {cfg.tolerance:.3e}; "
            "returning unconverged eigenpairs", RuntimeWarning,
            stacklevel=4)
    ritz_vecs = basis.T @ torch.as_tensor(s, device=basis.device).to(dtype)
    # unit columns (f32 drift); the basis is orthonormal by construction
    ritz_vecs = ritz_vecs / torch.linalg.vector_norm(ritz_vecs, dim=0)
    asc = np.argsort(ritz_vals)
    return (torch.as_tensor(ritz_vals[asc], device=basis.device).to(dtype),
            ritz_vecs[:, torch.as_tensor(asc, device=basis.device)], report)


def _restart_loop(extend, basis, t, v, cfg, k, ncv, which, dtype,
                  stats=None):
    """The host-driven thick-restart loop: Ritz test, then restart from
    the k kept Ritz vectors with the arrowhead projected matrix."""
    basis, t, beta_last, v = extend(0, basis, t, v, it=-1)
    for it in range(cfg.max_iterations):
        ritz_vals, s, residuals = _ritz(t, beta_last, which, k)
        if float(residuals.max()) < cfg.tolerance \
                or it == cfg.max_iterations - 1:
            return _finalize_ritz(basis, t, beta_last, it + 1, cfg, k,
                                  which, dtype, stats=stats)

        ritz_vecs = basis.T @ torch.as_tensor(s, device=basis.device).to(
            dtype)                                           # [n, k]
        q, r = torch.linalg.qr(ritz_vecs)
        signs = torch.sign(torch.diagonal(r))
        signs = torch.where(signs == 0, torch.ones_like(signs), signs)
        q = q * signs[None, :]                 # keep the original directions
        basis = torch.zeros_like(basis)
        basis[:k] = q.T
        t = np.zeros_like(t)
        t[np.arange(k), np.arange(k)] = ritz_vals
        # soft locking: a pair already below tol loses its coupling, so
        # degenerate eigenvalues resolve to their full multiplicity
        border = beta_last * s[-1, :]
        border = np.where(np.abs(border) < cfg.tolerance, 0.0, border)
        t[:k, k] = border
        t[k, :k] = border
        basis, t, beta_last, v = extend(k, basis, t, v, it=it)

    raise AssertionError("unreachable: the loop returns at max_iterations")
