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

:func:`eigsh_mnmg` is the row-partitioned solver over
``raft_tpu_torch.comms``, one process a rank: each rank holds a band of
the operator's rows (local rows, global columns) and the matching slice
of every basis vector. Its SpMV is ``csrc/csr_spmv.cu`` on the band over
the all-gathered vector, its dots and norms are all-reduced, and its
thick restart orthonormalizes the Ritz vectors by CholeskyQR2 across the
ranks. The host restart loop is the single-device solver's, shared.

Not ported yet: ``sync_every > 1`` (the reference's compiled restart
chunks; a CUDA-graph capture with queue A item 13b) and the obs events
(item 13b).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.core.guards import (ConvergenceError, ConvergenceReport,
                                        IllConditionedError)
from raft_tpu_torch.core.operators import exact_sqrt
from raft_tpu_torch.core.resources import as_tensor
from raft_tpu_torch.core.sparse_types import COOMatrix, CSRMatrix
from raft_tpu_torch.sparse import convert, grid_spmv, linalg, op
from raft_tpu_torch.util.input_validation import expect_one_sync
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


def _orthogonalize(v, basis, psum=None):
    """One Gram-Schmidt pass against the rows of ``basis``; ``psum``
    sums the coefficients over the ranks of a row-partitioned basis."""
    coeffs = basis @ v
    if psum is not None:
        coeffs = psum(coeffs)
    return v - basis.T @ coeffs, coeffs


def _norm(w, psum=None):
    """‖w‖, over every rank's slice when ``psum`` is given."""
    if psum is None:
        return torch.linalg.vector_norm(w)
    return exact_sqrt(psum(torch.sum(w * w)))


def _lanczos_step(matvec, basis, v, j: int, scale, psum=None):
    """Lanczos step j on the device: writes ``v`` into ``basis[j]`` (in
    place), applies the operator and orthogonalizes twice. Returns
    ``(w, alpha, beta, scale, bad)``: the residual, the tridiagonal
    entries, the running operator scale (max ‖A·v‖) and the breakdown
    flag ``beta < √eps · scale``, all still on the device."""
    basis[j] = v
    w = matvec(v)
    scale = torch.maximum(scale, _norm(w, psum))
    w, c1 = _orthogonalize(w, basis, psum)
    w, c2 = _orthogonalize(w, basis, psum)
    alpha = c1[j] + c2[j]
    b = _norm(w, psum)
    fi = torch.finfo(basis.dtype)
    tol_b = fi.eps ** 0.5 * torch.clamp_min(scale, fi.tiny * 1e4)
    return w, alpha, b, scale, b < tol_b


def _extend_device(matvec, basis, v, seed: int, j_start: int, ncv: int,
                   psum=None, fresh=None):
    """Grow Krylov rows ``[j_start, ncv)``. Returns ``(basis, ab [2, ncv],
    breakdown [ncv] bool, v_next)`` on the device: ``ab[:, j]`` are step
    j's (alpha, beta), ``breakdown[j]`` flags a residual below the
    relative threshold, after which the step continues from a random
    direction orthogonal to the basis (drawn from a generator seeded with
    ``seed``), as the reference does. A row-partitioned basis passes
    ``psum`` (the all-reduce of dots and norms) and ``fresh(gen)``, this
    rank's slice of the random direction."""
    dev, dtype = basis.device, basis.dtype
    alphas = torch.zeros(ncv, dtype=dtype, device=dev)
    betas = torch.zeros(ncv, dtype=dtype, device=dev)
    brk = torch.zeros(ncv, dtype=torch.bool, device=dev)
    scale = torch.zeros((), dtype=dtype, device=dev)
    gen = None
    for j in range(j_start, ncv):
        w, alpha, b, scale, bad = _lanczos_step(matvec, basis, v, j, scale,
                                                psum)
        b_div = b
        if bool(bad):                               # the host sync a step
            if gen is None:
                gen = torch.Generator(device=dev).manual_seed(seed)
            w = (fresh(gen) if fresh is not None else
                 torch.randn(basis.shape[1], generator=gen, dtype=dtype,
                             device=dev))
            w, _ = _orthogonalize(w, basis, psum)
            w, _ = _orthogonalize(w, basis, psum)
            b_div = _norm(w, psum)
        alphas[j] = alpha
        betas[j] = b                                # pre-recovery coupling
        brk[j] = bad
        v = w / b_div
    return basis, torch.stack([alphas, betas]), brk, v


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
    expect_one_sync(sync_every, "lanczos")

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
                   stats=None, psum=None):
    """Solve the projected problem, test convergence, back-transform the
    kept pairs and build the report (warn, or raise under ``strict``).
    With ``psum`` the basis is this rank's slice, and so are the
    vectors."""
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
    if psum is None:
        ritz_vecs = ritz_vecs / torch.linalg.vector_norm(ritz_vecs, dim=0)
    else:
        ritz_vecs = ritz_vecs / exact_sqrt(
            psum(torch.sum(ritz_vecs * ritz_vecs, dim=0)))
    asc = np.argsort(ritz_vals)
    return (torch.as_tensor(ritz_vals[asc], device=basis.device).to(dtype),
            ritz_vecs[:, torch.as_tensor(asc, device=basis.device)], report)


def _restart_basis(basis, s, k: int):
    """The thick restart's new basis: the k kept Ritz vectors, made
    orthonormal by Householder QR with R's diagonal made positive (so
    they keep their directions)."""
    ritz_vecs = basis.T @ torch.as_tensor(s, device=basis.device).to(
        basis.dtype)                                         # [n, k]
    q, r = torch.linalg.qr(ritz_vecs)
    signs = torch.sign(torch.diagonal(r))
    signs = torch.where(signs == 0, torch.ones_like(signs), signs)
    out = torch.zeros_like(basis)
    out[:k] = (q * signs[None, :]).T
    return out


def _restart_loop(extend, basis, t, v, cfg, k, ncv, which, dtype,
                  on_iteration=None, resume=None, stats=None, psum=None):
    """The host-driven thick-restart loop, shared by :func:`eigsh` and
    :func:`eigsh_mnmg`: Ritz test, then restart from the k kept Ritz
    vectors with the arrowhead projected matrix.

    ``on_iteration(it, basis, t, beta_last, v)`` fires at the top of
    each outer iteration (the MNMG checkpoint and health probe): the
    state there determines the rest of the run, since the extension's
    seeds derive from (seed, it, j_start). ``resume=(it0, beta_last)``
    skips the first extension and enters the loop at ``it0`` with the
    given ``basis``/``t``/``v``. ``psum`` marks a row-partitioned basis:
    the restart orthonormalizes across the ranks
    (:func:`_mnmg_restart_step`)."""
    from raft_tpu_torch.runtime import limits

    if resume is None:
        basis, t, beta_last, v = extend(0, basis, t, v, it=-1)
        it0 = 0
    else:
        it0, beta_last = resume
    for it in range(it0, cfg.max_iterations):
        if on_iteration is not None:
            on_iteration(it, basis, t, beta_last, v)
        # the deadline poll follows the hook, so an expiring deadline
        # leaves the checkpoint just saved
        limits.check_deadline("sparse.solver.lanczos")
        ritz_vals, s, residuals = _ritz(t, beta_last, which, k)
        if float(residuals.max()) < cfg.tolerance \
                or it == cfg.max_iterations - 1:
            return _finalize_ritz(basis, t, beta_last, it + 1, cfg, k,
                                  which, dtype, stats=stats, psum=psum)

        basis = (_restart_basis(basis, s, k) if psum is None
                 else _mnmg_restart_step(basis, s, k, psum))
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


# ---------------------------------------------------------------------------
# MNMG: row-partitioned Lanczos, one process a rank
# ---------------------------------------------------------------------------


def _band(csr: CSRMatrix, rank: int, n_local: int, n_pad: int) -> CSRMatrix:
    """Rows ``[rank·n_local, (rank+1)·n_local)`` of ``csr`` as a CSR of
    local rows and global columns, [n_local, n_pad]; rows past the
    matrix are empty."""
    n = csr.shape[0]
    r0, r1 = min(rank * n_local, n), min((rank + 1) * n_local, n)
    ptr = csr.indptr[r0:r1 + 1].to(torch.int64)
    lo, hi = int(ptr[0]), int(ptr[-1])
    ptr = ptr - lo
    if r1 - r0 < n_local:
        ptr = torch.cat([ptr, ptr[-1:].expand(n_local - (r1 - r0))])
    return CSRMatrix(ptr.to(csr.indptr.dtype), csr.indices[lo:hi],
                     csr.data[lo:hi].to(torch.float32), (n_local, n_pad))


def _extend_mnmg_body(band_plan, basis_l, v_l, seed: int, j_start: int,
                      ncv: int, n_true: int, ax):
    """This rank's Lanczos extension: it owns a row band of the operator
    (``band_plan``, the prepared CSR of local rows and global columns)
    and the matching slice of every basis vector. The SpMV is the band's
    product (``csrc/csr_spmv.cu``) with the all-gathered vector; every
    dot and norm is all-reduced over the axis ``ax``. A breakdown's
    random direction is the single-device draw of length n, this rank's
    slice of it (zero past row n)."""
    from raft_tpu_torch.comms import device as dev

    def psum(x):
        return dev.allreduce(x, dev.Op.SUM, axis_name=ax)

    def matvec(v):
        return grid_spmv.spmv(band_plan, dev.allgather(v, axis_name=ax,
                                                       tiled=True))

    n_local = basis_l.shape[1]

    def fresh(gen):
        w = torch.randn(n_true, generator=gen, dtype=basis_l.dtype,
                        device=basis_l.device)
        w = torch.nn.functional.pad(w, (0, n_local * ax.size - n_true))
        return w[ax.index * n_local:(ax.index + 1) * n_local]

    return _extend_device(matvec, basis_l, v_l, seed, j_start, ncv,
                          psum=psum, fresh=fresh)


def _cholqr2(a_l, psum):
    """Thin QR of a row-partitioned [n_local, k] block by CholeskyQR2:
    the Gram matrix all-reduced, its Cholesky factor, a triangular
    solve, twice. R (a product of Cholesky factors) has a positive
    diagonal, the sign rule of :func:`_restart_basis`."""
    def one_round(q_l):
        # Q = A L^-T: a tall right-hand side, one triangular solve
        ell = torch.linalg.cholesky(psum(q_l.T @ q_l))
        return torch.linalg.solve_triangular(ell.T, q_l, upper=True,
                                             left=False)

    return one_round(one_round(a_l))


def _mnmg_restart_step(basis_l, s, k: int, psum):
    """The thick restart's new basis on this rank's slice: the Ritz
    back-transform stays row-partitioned, orthonormalized across the
    ranks by :func:`_cholqr2`."""
    ritz_l = basis_l.T @ torch.as_tensor(s, device=basis_l.device).to(
        basis_l.dtype)                                        # [n_local, k]
    out = torch.zeros_like(basis_l)
    out[:k] = _cholqr2(ritz_l, psum).T
    return out


@with_matmul_precision
def eigsh_mnmg(a, k: int = 6, mesh=None, axis: str = "data",
               which: str = "SA", v0=None, ncv: int = 0,
               maxiter: int = 1000, tol: float = 1e-7,
               seed: int = 42, comms=None,
               checkpoint_every: Optional[int] = None,
               checkpoint_dir: Optional[str] = None,
               checkpoint_keep: int = 2,
               resume_from: Optional[str] = None,
               strict: bool = False,
               return_report: bool = False,
               sync_every: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multi-rank eigsh: ``(eigenvalues [k], eigenvectors [n, k])``, the
    same on every rank.

    One process a rank: every rank of ``mesh`` (a ``DeviceMesh``) calls
    this with the same symmetric operator ``a`` (CSR or COO on the
    ranks' device). Rank r owns rows ``[r·n_local, (r+1)·n_local)``,
    ``n_local = ceil(n / ranks)``, as a band of local rows and global
    columns, and that slice of the basis (see :func:`_extend_mnmg_body`);
    the Ritz problem is solved on every rank alike in f64. Same start
    vector as the reference (``np.random.default_rng(seed)``).

    Elastic execution: ``checkpoint_every=n`` saves the restart state
    (unpadded basis, projected matrix t, residual vector, beta_last,
    iteration; prefix ``eigsh``) every n-th outer restart, written by
    rank 0; with a ``comms`` clique each restart health-checks it
    (collectively), and on a failure the survivors agree, shrink,
    rebuild the row bands for their count and resume from the newest
    checkpoint. ``resume_from`` is a checkpoint file or directory.
    ``sync_every > 1`` raises ``NotImplementedError``."""
    from raft_tpu_torch.comms import device as dev
    from raft_tpu_torch.comms.errors import CommsAbortedError, PeerFailedError
    from raft_tpu_torch.core import checkpoint as core_ckpt
    from raft_tpu_torch.core import logger, trace

    if mesh is None:
        raise ValueError("eigsh_mnmg requires a DeviceMesh")
    csr = a
    if isinstance(csr, COOMatrix):
        csr = convert.sorted_coo_to_csr(op.coo_sort(csr))
    n = csr.shape[0]
    cfg = LanczosConfig(n_components=k, max_iterations=maxiter, ncv=ncv,
                        tolerance=tol, which=which.upper(), seed=seed,
                        strict=strict)
    if k <= 0 or k >= n:
        raise ValueError(f"need 0 < k < n, got {k} vs {n}")
    if cfg.max_iterations < 1:
        raise ValueError(
            f"max_iterations must be >= 1, got {cfg.max_iterations}")
    ncv = cfg.ncv if cfg.ncv else min(n, max(2 * k + 1, 20))
    ncv = min(max(ncv, k + 2), n)
    which = cfg.which
    if which not in ("LA", "LM", "SA", "SM"):
        raise ValueError(f"which must be LA|LM|SA|SM, got {which}")
    expect_one_sync(sync_every, "lanczos")
    dtype = torch.float32
    device = csr.data.device

    manager = None
    if checkpoint_every is not None:
        if checkpoint_dir is None:
            raise ValueError("checkpoint_every requires checkpoint_dir")
        manager = core_ckpt.CheckpointManager(
            checkpoint_dir, prefix="eigsh", keep=checkpoint_keep)
    stride = (max(1, int(checkpoint_every))
              if checkpoint_every is not None else None)
    stats = {"breakdowns": 0}

    def build(cur_mesh):
        """Everything that depends on the rank count: the axis, this
        rank's band and its plan, and ``place`` to pad host state and
        take this rank's slice. The unpadded state (basis[:, :n], v[:n])
        carries over between rank counts: the pad rows of the operator
        are empty and every path keeps the pad slots 0."""
        ax = dev._axis_of_mesh(cur_mesh, axis)
        n_local = -(-n // ax.size)
        n_pad = n_local * ax.size
        plan = linalg._cached_plan(_band(csr, ax.index, n_local, n_pad))
        mine = slice(ax.index * n_local, (ax.index + 1) * n_local)

        def psum(x):
            return dev.allreduce(x, dev.Op.SUM, axis_name=ax)

        def gather(x_l):
            """The unpadded global [n] or [n, ...] from every rank's
            rows."""
            return dev.allgather(x_l, axis_name=ax, tiled=True)[:n]

        def extend(j_start, basis_l, t, v_l, it):
            basis_l, ab, brk, v_l = _extend_mnmg_body(
                plan, basis_l, v_l, cfg.seed + 7919 * (it + 1) + j_start,
                j_start, ncv, n, ax)
            ab_h = ab.cpu().numpy().astype(np.float64)
            brk_h = brk.cpu().numpy()
            stats["breakdowns"] += int(brk_h[j_start:].sum())
            for j in range(j_start, ncv):
                t[j, j] = ab_h[0, j]
                if j + 1 < ncv:
                    t[j, j + 1] = t[j + 1, j] = ab_h[1, j]
            beta_last = 0.0 if brk_h[ncv - 1] else float(ab_h[1, ncv - 1])
            return basis_l, t, beta_last, v_l

        def place(basis_h, v_h):
            b = torch.zeros((ncv, n_pad), dtype=dtype, device=device)
            b[:, :n] = torch.as_tensor(basis_h, device=device)
            vp = torch.zeros(n_pad, dtype=dtype, device=device)
            vp[:n] = torch.as_tensor(v_h, device=device)
            return b[:, mine].contiguous(), vp[mine].contiguous()

        return ax, psum, gather, extend, place

    t = np.zeros((ncv, ncv), dtype=np.float64)
    resume = None
    if resume_from is not None:
        entries = _load_eigsh_checkpoint(resume_from)
        basis_h = np.asarray(entries["basis"], np.float32)
        v_h = np.asarray(entries["v"], np.float32)
        t = np.asarray(entries["t"], np.float64).copy()
        resume = (int(entries["it"]), float(entries["beta_last"]))
    else:
        rng = np.random.default_rng(cfg.seed)
        v_h = (np.asarray(v0, np.float32) if v0 is not None
               else rng.standard_normal(n).astype(np.float32))
        nv = float(np.linalg.norm(v_h))
        if not nv > 0 or not np.isfinite(nv):
            raise IllConditionedError(
                f"eigsh_mnmg: starting vector v0 has norm {nv!r}; cannot "
                "normalize a zero or non-finite direction",
                op="sparse.solver.eigsh_mnmg")
        v_h = v_h / np.linalg.norm(v_h)
        basis_h = np.zeros((ncv, n), np.float32)

    ax, psum, gather, extend, place = build(mesh)
    basis, v = place(basis_h, v_h)

    def on_iteration(it, basis_l, t_d, beta_last_d, v_l):
        # checkpoint FIRST, then the health probe: a failure it finds
        # recovers from exactly this state
        if manager is not None and it % stride == 0:
            basis_g = gather(basis_l.T).T
            v_g = gather(v_l)
            if ax.index == 0:
                manager.save(it, {
                    "basis": basis_g, "t": np.asarray(t_d, np.float64),
                    "v": v_g, "beta_last": float(beta_last_d),
                    "it": int(it)})
        if comms is not None:
            comms.ensure_healthy()

    hook = (on_iteration if (manager is not None or comms is not None)
            else None)
    while True:
        try:
            w, vecs_l, report = _restart_loop(
                extend, basis, t, v, cfg, k, ncv, which, dtype,
                on_iteration=hook, resume=resume, stats=stats, psum=psum)
            break
        except (PeerFailedError, CommsAbortedError) as err:
            if comms is None or manager is None:
                raise
            latest = manager.restore_latest()
            if latest is None:
                raise
            step, entries = latest
            survivors = comms.agree_on_survivors()
            comms = comms.shrink(survivors)     # an evicted rank raises
            logger.warn("eigsh_mnmg: peer failure (%s); resuming restart "
                        "%d on %d survivors", err, step, len(survivors))
            trace.record_event("eigsh.elastic_resume", step=step,
                               survivors=len(survivors))
            ax, psum, gather, extend, place = build(comms.mesh)
            basis, v = place(np.asarray(entries["basis"], np.float32),
                             np.asarray(entries["v"], np.float32))
            t = np.asarray(entries["t"], np.float64).copy()
            resume = (int(entries["it"]), float(entries["beta_last"]))
    vecs = gather(vecs_l)
    if return_report:
        return w, vecs, report
    return w, vecs


def _load_eigsh_checkpoint(resume_from):
    import os

    from raft_tpu_torch.core import checkpoint as core_ckpt

    if os.path.isdir(resume_from):
        latest = core_ckpt.CheckpointManager(
            resume_from, prefix="eigsh").restore_latest()
        if latest is None:
            raise FileNotFoundError(
                f"no eigsh checkpoints under {resume_from!r}")
        return latest[1]
    return core_ckpt.restore_checkpoint(resume_from)
