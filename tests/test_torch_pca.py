"""The port's PCA and truncated SVD (raft_tpu_torch.linalg.pca) against
the reference package on the same seeded numpy inputs (CPU tensors on
the port's side).

Tolerances: means and variances 1e-4 relative (both packages form the
covariance in f32 in another order), components 1e-3 after the sign
flip (both flip the same way, so they are compared as they come), the
randomized solver to the exact fit's explained variance (its sketch is
torch's stream, not JAX's). The incremental fit matches the monolithic
fit to the same bands, and its resume from a mid-batch checkpoint is
bitwise equal to the unbroken run.
"""

import os

import numpy as np
import pytest
import torch

from _torch_util import n, t
from raft_tpu import linalg as rl
from raft_tpu_torch import device_resources
from raft_tpu_torch import linalg as tl
from raft_tpu_torch.core import trace
from raft_tpu_torch.random.rng_state import RngState

RES = device_resources("cpu")


@pytest.fixture(scope="module")
def X():
    rng = np.random.default_rng(42)
    return (rng.normal(size=(600, 16)) @ rng.normal(size=(16, 16))
            ).astype(np.float32)


def _close(got, want, rtol=1e-4, atol=1e-5):
    np.testing.assert_allclose(n(got).astype(np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol)


def _same_fit(got, want, comp_atol=1e-3):
    _close(got.mean, want.mean, atol=1e-4)
    _close(got.explained_variance, want.explained_variance)
    _close(got.explained_variance_ratio, want.explained_variance_ratio)
    _close(got.singular_values, want.singular_values)
    _close(got.components, want.components, atol=comp_atol)
    _close(got.noise_variance, want.noise_variance, rtol=1e-3)


@pytest.mark.parametrize("solver", ["COV_EIG_DQ", "COV_EIG_JACOBI"])
@pytest.mark.parametrize("n_components", [5, 16])
def test_pca_fit_matches_the_reference(X, solver, n_components):
    got = tl.pca_fit(RES, t(X), n_components, solver=tl.Solver[solver])
    want = rl.pca_fit(None, X, n_components, solver=rl.Solver[solver])
    _same_fit(got, want)
    assert all(isinstance(f, torch.Tensor) for f in got)


@pytest.mark.parametrize("whiten", [False, True])
def test_pca_transforms(X, whiten):
    got = tl.pca_fit(RES, t(X), 5)
    want = rl.pca_fit(None, X, 5)
    tt = tl.pca_transform(RES, t(X), got, whiten=whiten)
    _close(tt, rl.pca_transform(None, X, want, whiten=whiten), atol=1e-3)
    back = tl.pca_inverse_transform(RES, tt, got, whiten=whiten)
    _close(back, rl.pca_inverse_transform(
        None, rl.pca_transform(None, X, want, whiten=whiten), want,
        whiten=whiten), atol=1e-3)
    full = tl.pca_fit(RES, t(X), 16)
    _close(tl.pca_inverse_transform(
        RES, tl.pca_transform(RES, t(X), full, whiten=whiten), full,
        whiten=whiten), X, atol=1e-3)
    ft, res_ft = tl.pca_fit_transform(RES, t(X), 5)
    _close(ft, tl.pca_transform(RES, t(X), got), atol=1e-5)
    _close(res_ft.components, got.components, atol=1e-6)


def test_pca_randomized_and_validation(X):
    exact = tl.pca_fit(RES, t(X), 4)
    got = tl.pca_fit(RES, t(X), 4, solver=tl.Solver.RANDOMIZED,
                     state=RngState(3))
    want = rl.pca_fit(None, X, 4, solver=rl.Solver.RANDOMIZED)
    _close(got.explained_variance, exact.explained_variance, rtol=1e-3)
    _close(got.explained_variance, want.explained_variance, rtol=1e-3)
    _close(got.components, exact.components, atol=5e-3)
    with pytest.raises(ValueError):
        tl.pca_fit(RES, t(X), 0)
    with pytest.raises(ValueError):
        tl.pca_fit(RES, t(X[0]), 2)


@pytest.mark.parametrize("solver", ["COV_EIG_DQ", "RANDOMIZED"])
def test_tsvd_matches_the_reference(X, solver):
    got = tl.tsvd_fit(RES, t(X), 4, solver=tl.Solver[solver])
    want = rl.tsvd_fit(None, X, 4, solver=rl.Solver[solver])
    rtol = 1e-4 if solver == "COV_EIG_DQ" else 1e-3
    _close(got.singular_values, want.singular_values, rtol=rtol)
    _close(got.explained_variance, want.explained_variance, rtol=rtol)
    _close(got.explained_variance_ratio, want.explained_variance_ratio,
           rtol=rtol)
    _close(got.components, want.components, atol=5e-3)
    tt = tl.tsvd_transform(RES, t(X), got)
    _close(tt, rl.tsvd_transform(None, X, want), rtol=1e-3, atol=1e-2)
    _close(tl.tsvd_inverse_transform(RES, tt, got),
           rl.tsvd_inverse_transform(None, rl.tsvd_transform(None, X, want),
                                     want), rtol=1e-3, atol=1e-2)
    ft, _ = tl.tsvd_fit_transform(RES, t(X), 4, solver=tl.Solver[solver])
    assert ft.shape == (600, 4)


def test_cal_eig_and_sign_flip(X):
    cov = np.cov(X.T).astype(np.float32)
    w, v = tl.cal_eig(RES, t(cov), 3)
    rw, rv = rl.cal_eig(None, cov, 3)
    _close(w, rw)
    comps, u = tl.sign_flip_components(t(np.asarray(rv).T.copy()),
                                       U=t(np.ones((2, 3), np.float32)))
    rcomps, ru = rl.sign_flip_components(np.asarray(rv).T, U=np.ones((2, 3)))
    _close(comps, rcomps, atol=0)
    _close(u, ru, atol=0)
    _close(tl.sign_flip_components(-comps), rcomps, atol=0)
    # an all-zero component keeps its sign (+1)
    z = tl.sign_flip_components(t(np.zeros((1, 3), np.float32)))
    assert not z.any()


# -- incremental PCA ---------------------------------------------------------


def test_chunked_matches_monolithic(X):
    full = tl.pca_fit(RES, t(X), 5)
    st = tl.pca_partial_fit(RES, t(X), chunk_rows=64)
    inc = tl.pca_finalize(RES, st, 5)
    _same_fit(inc, full)
    ref = rl.pca_finalize(None, rl.pca_partial_fit(None, X, chunk_rows=64), 5)
    _same_fit(inc, ref)
    _close(st.scatter, rl.pca_partial_fit(None, X, chunk_rows=64).scatter,
           rtol=1e-4, atol=1e-2)


def test_two_batch_streaming_and_pad_tail(X):
    one = tl.pca_partial_fit(RES, t(X), chunk_rows=256)
    s1 = tl.pca_partial_fit(RES, t(X[:277]), chunk_rows=128)
    _close(s1.mean, X[:277].mean(0), atol=1e-4)
    assert float(s1.count) == 277.0
    s2 = tl.pca_partial_fit(RES, t(X[277:]), state=s1, chunk_rows=128)
    assert float(s2.count) == 600.0
    _close(s2.mean, one.mean, atol=1e-4)
    _close(s2.scatter, one.scatter, rtol=1e-3, atol=1e-2)
    r1 = rl.pca_partial_fit(None, X[:277], chunk_rows=128)
    r2 = rl.pca_partial_fit(None, X[277:], state=r1, chunk_rows=128)
    _close(s2.mean, r2.mean, atol=1e-4)
    _close(s2.scatter, r2.scatter, rtol=1e-4, atol=1e-2)


def test_checkpoint_resume_mid_batch_is_bitwise(X, tmp_path):
    full = tl.pca_partial_fit(RES, t(X), chunk_rows=64,
                              checkpoint_dir=str(tmp_path),
                              checkpoint_every=3, checkpoint_keep=10)
    files = sorted(os.listdir(tmp_path))
    # every third chunk boundary and the last (10 chunks)
    assert files == [f"pca_pf-{s:08d}.ckpt" for s in (3, 6, 9, 10)]
    for name in files[:3]:
        resumed = tl.pca_partial_fit(RES, t(X), chunk_rows=64,
                                     resume_from=str(tmp_path / name))
        for a, b in zip(resumed, full):
            assert torch.equal(a, b), name
    # a directory resumes from its newest checkpoint: the end of the batch
    done = tl.pca_partial_fit(RES, t(X), chunk_rows=64,
                              resume_from=str(tmp_path))
    assert all(torch.equal(a, b) for a, b in zip(done, full))
    # the reference reads the port's checkpoint file and lands on the same
    # statistics
    ref = rl.pca_partial_fit(None, X, chunk_rows=64,
                             resume_from=str(tmp_path / files[1]))
    _close(full.mean, ref.mean, atol=1e-4)
    _close(full.scatter, ref.scatter, rtol=1e-4, atol=1e-2)
    with pytest.raises(ValueError, match="SAME batch"):
        tl.pca_partial_fit(RES, t(X[:100]), chunk_rows=64,
                           resume_from=str(tmp_path / files[-1]))


def test_trace_and_validation(X):
    trace.clear_events()
    tl.pca_partial_fit(RES, t(X[:300]), chunk_rows=100)
    ev = trace.events("pca.partial_fit")
    assert ev and ev[-1]["rows"] == 300 and ev[-1]["chunks"] == 3
    assert ev[-1]["n_cols"] == 16 and ev[-1]["chunk_rows"] == 100
    st = tl.pca_partial_fit(RES, t(X[:100]), chunk_rows=64)
    with pytest.raises(ValueError, match="columns"):
        tl.pca_partial_fit(RES, t(X[:100, :8]), state=st)
    with pytest.raises(ValueError, match="rows"):
        tl.pca_finalize(RES, tl.IncrementalPCAState(
            torch.zeros(4), torch.zeros((4, 4)), torch.zeros(())), 2)
    with pytest.raises(ValueError, match="checkpoint_dir"):
        tl.pca_partial_fit(RES, t(X), checkpoint_every=1)
    with pytest.raises(ValueError):
        tl.pca_partial_fit(RES, t(X[:0]))
    with pytest.raises(NotImplementedError, match="item 13"):
        tl.pca_partial_fit(RES, t(X), sync_every=2)
