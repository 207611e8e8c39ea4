"""The port's thick-restart Lanczos (raft_tpu_torch.sparse.solver) against
the reference's ``eigsh`` on the same operators (CPU tensors: the SpMV is
the CSR kernel's plain version, the dense operator a matmul).

Both start from the same vector (``np.random.default_rng(seed)``), so
without a breakdown the runs take the same steps: eigenvalues agree to
1e-4 relative (of the spectrum's scale for values near 0), each
eigenvector up to sign (|⟨u_ref, u⟩| >= 1 − 1e-3), and the convergence
report's ``converged`` and ``n_iter`` are equal. After a breakdown the
restart directions come from different generators (JAX keys, torch
Philox), so the ring of cliques, the invariant-subspace stress case, is
compared on eigenvalues only.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from _torch_util import n, t
from raft_tpu.core.sparse_types import CSRMatrix as JCSR
from raft_tpu.sparse.solver import lanczos as jl
from raft_tpu_torch import device_resources, interop
from raft_tpu_torch.core.guards import (ConvergenceError,
                                        IllConditionedError)
from raft_tpu_torch.core.sparse_types import COOMatrix, CSRMatrix
from raft_tpu_torch.sparse.solver import lanczos as tl
from tests.conftest import ring_of_cliques
from tests.test_spectral_partition import _KARATE_EDGES


def _port(j):
    return interop.csr_from_numpy(np.asarray(j.indptr), np.asarray(j.indices),
                                  np.asarray(j.data), j.shape,
                                  res=device_resources("cpu"))


def _sym_random(seed, n_=300, density=0.03):
    rng = np.random.default_rng(seed)
    a = sp.random(n_, n_, density=density, random_state=rng,
                  data_rvs=rng.standard_normal, format="csr",
                  dtype=np.float32)
    return (a + a.T).tocsr()


def _karate():
    src, dst = np.asarray(_KARATE_EDGES).T
    a = sp.coo_matrix((np.ones(len(src), np.float32), (src, dst)),
                      shape=(34, 34))
    return (a + a.T).tocsr()


def _karate_laplacian():
    a = _karate()
    return (sp.diags(np.asarray(a.sum(1)).ravel()) - a).tocsr().astype(
        np.float32)


def _compare(jout, tout, scale, vectors=True, report=True):
    jw, jv, jrep = jout
    tw, tv, trep = tout
    jw, jv, tw, tv = map(np.asarray, (jw, jv, n(tw), n(tv)))
    np.testing.assert_allclose(tw, jw, rtol=1e-4, atol=1e-4 * scale)
    assert tv.shape == jv.shape
    if vectors:
        dots = np.abs(np.sum(tv.astype(np.float64) * jv, axis=0))
        assert np.all(dots >= 1 - 1e-3), dots
    if report:
        assert jrep.breakdowns == trep.breakdowns == 0
        assert trep.converged == jrep.converged
        assert trep.n_iter == jrep.n_iter


@pytest.mark.parametrize("k", [2, 3, 4, 5, 6])
@pytest.mark.parametrize("which", ["LA", "SA", "LM", "SM"])
def test_eigsh_matches_reference(which, k):
    a = _sym_random(k)
    if which == "SM":
        # magnitude order without shift-invert converges only where the
        # smallest magnitudes are extremal: shift the spectrum positive
        shift = float(abs(a).sum(1).max()) + 0.5
        a = (a + shift * sp.eye(a.shape[0], dtype=np.float32)).tocsr()
    j = JCSR.from_scipy(a)
    kw = dict(k=k, which=which, maxiter=300, tol=1e-6, return_report=True)
    jout = jl.eigsh(j, **kw)
    tout = tl.eigsh(_port(j), **kw)
    scale = float(np.abs(np.asarray(jout[0])).max())
    _compare(jout, tout, scale)


@pytest.mark.parametrize("case", ["karate_laplacian", "dense", "unpadded",
                                  "coo", "v0"])
def test_eigsh_operators_match_reference(case):
    lap = _karate_laplacian()
    kw = dict(k=4, which="SA", tol=1e-6, return_report=True)
    if case == "dense":
        d = lap.toarray()
        jout = jl.eigsh(d, **kw)
        tout = tl.eigsh(t(d), **kw)
    elif case == "coo":
        j = JCSR.from_scipy(lap)
        jout = jl.eigsh(j, **kw)
        coo = lap.tocoo()
        perm = np.random.default_rng(0).permutation(coo.nnz)
        tout = tl.eigsh(COOMatrix(t(coo.row[perm].astype(np.int32)),
                                  t(coo.col[perm].astype(np.int32)),
                                  t(coo.data[perm]), lap.shape), **kw)
    else:
        pad = case != "unpadded"
        j = JCSR.from_scipy(lap, pad=pad)
        c = _port(j)
        assert (c.nnz > c.logical_nnz()) == pad
        v0 = None
        if case == "v0":
            v0 = np.random.default_rng(3).uniform(-1, 1, 34).astype(
                np.float32)
        jout = jl.eigsh(j, v0=v0, **kw)
        tout = tl.eigsh(c, v0=None if v0 is None else t(v0), **kw)
    _compare(jout, tout, float(np.abs(np.asarray(jout[0])).max()) + 1.0)


def test_rank1_modularity_operator_matches_reference():
    """A − d·dᵀ/2m, applied matrix-free, largest eigenpairs."""
    a = _karate()
    deg = np.asarray(a.sum(1)).ravel().astype(np.float32)
    alpha = np.float32(-1.0 / deg.sum())
    cfg = dict(n_components=3, which="LA", tolerance=1e-6)
    j = JCSR.from_scipy(a)
    jout = jl.lanczos_compute_eigenpairs(
        None, j, jl.LanczosConfig(**cfg), rank1=(deg, deg, alpha),
        return_report=True)
    tout = tl.lanczos_compute_eigenpairs(
        None, _port(j), interop.lanczos_config_from_dict(cfg),
        rank1=(t(deg), t(deg), alpha), return_report=True)
    _compare(jout, tout, float(np.abs(np.asarray(jout[0])).max()))


@pytest.mark.parametrize("k", [2, 4])
def test_ring_of_cliques_eigenvalues_match_reference(k):
    """Few distinct eigenvalues: the extension breaks down and restarts
    from a random direction, whose bits differ between the packages."""
    j = ring_of_cliques()
    jw, _, jrep = jl.eigsh(j, k=k, which="SA", return_report=True)
    tw, tv, trep = tl.eigsh(_port(j), k=k, which="SA", return_report=True)
    np.testing.assert_allclose(n(tw), np.asarray(jw), rtol=1e-4, atol=1e-4)
    assert trep.converged and jrep.converged
    a = j.to_scipy()
    resid = np.abs(a @ n(tv) - n(tv) * n(tw)).max()
    assert resid < 1e-2


def test_strict_raises_convergence_error():
    c = _port(JCSR.from_scipy(_sym_random(11)))
    with pytest.raises(ConvergenceError) as e:
        tl.eigsh(c, k=3, maxiter=1, tol=1e-12, strict=True)
    assert e.value.report.n_iter == 1 and not e.value.report.converged
    with pytest.warns(RuntimeWarning, match="unconverged"):
        _, _, rep = tl.eigsh(c, k=3, maxiter=1, tol=1e-12,
                             return_report=True)
    assert not rep.converged


def test_left_out_paths_raise_not_implemented():
    from raft_tpu_torch.spectral import partition

    c = _port(JCSR.from_scipy(_sym_random(12)))
    with pytest.raises(NotImplementedError, match="item 13"):
        tl.eigsh(c, k=2, sync_every=4)
    with pytest.raises(ValueError, match="sync_every"):
        tl.eigsh(c, k=2, sync_every=0)
    with pytest.raises(NotImplementedError, match="item 7"):
        tl.eigsh_mnmg(c, k=2, mesh=object())
    with pytest.raises(NotImplementedError, match="item 7"):
        partition(None, c, 2, mesh=object())
    w1, _ = tl.eigsh(c, k=2, sync_every=1)
    w2, _ = tl.eigsh(c, k=2)
    assert torch.equal(w1, w2)


def test_bad_inputs_raise():
    c = _port(JCSR.from_scipy(_sym_random(13, n_=40, density=0.2)))
    with pytest.raises(IllConditionedError):
        tl.eigsh(c, k=2, v0=torch.zeros(40))
    with pytest.raises(IllConditionedError):
        tl.eigsh(c, k=2, v0=torch.full((40,), float("nan")))
    with pytest.raises(ValueError, match="n_components"):
        tl.eigsh(c, k=40)
    with pytest.raises(ValueError, match="which"):
        tl.eigsh(c, k=2, which="XX")
    with pytest.raises(ValueError, match="square"):
        tl.eigsh(torch.ones(3, 4), k=1)
    assert isinstance(c, CSRMatrix)
