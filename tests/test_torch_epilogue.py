"""The port's epilogue primitives (raft_tpu_torch/matrix/epilogue.py)
against the reference package's (raft_tpu/matrix/epilogue.py), bit for
bit: these are exact index and value selections, no arithmetic."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_util import n, t
from raft_tpu.matrix import epilogue as jep
from raft_tpu_torch.matrix import epilogue as tep


def _tile(seed, rows=33, cols=40, nan=True):
    """A distance tile with exact ties (values on a coarse grid) and,
    optionally, NaNs in two rows."""
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 6, size=(rows, cols)).astype(np.float32)
    if nan:
        d[3, [7, 20]] = np.nan
        d[5, :] = np.nan
    return d


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("finite", [False, True])
@pytest.mark.parametrize("n_valid", [40, 29])
def test_iota_argmin_matches_reference(seed, finite, n_valid):
    d = _tile(seed, nan=not finite)
    jcol, jmin, jarg = jep.iota_argmin(jnp.asarray(d), n_valid,
                                       finite=finite)
    tcol, tmin, targ = tep.iota_argmin(t(d), n_valid, finite=finite)
    np.testing.assert_array_equal(n(tcol), n(jcol))
    np.testing.assert_array_equal(n(tmin), n(jmin))     # NaN == NaN here
    np.testing.assert_array_equal(n(targ), n(jarg))
    assert targ.dtype == torch.int32


@pytest.mark.parametrize("seed", [0, 1])
def test_argmin_ref_matches_reference(seed):
    d = _tile(seed)
    jv, ja = jep.argmin_ref(jnp.asarray(d))
    tv, ta = tep.argmin_ref(t(d))
    np.testing.assert_array_equal(n(tv), n(jv))
    np.testing.assert_array_equal(n(ta), n(ja))


@pytest.mark.parametrize("masked", [False, True])
def test_assign_onehot_matches_reference(masked):
    d = _tile(4, nan=False)
    jcol, _, jarg = jep.iota_argmin(jnp.asarray(d), 40, finite=True)
    tcol, _, targ = tep.iota_argmin(t(d), 40, finite=True)
    mask = (np.arange(d.shape[0]) < 30)[:, None] if masked else None
    jo = jep.assign_onehot(jcol, jarg,
                           None if mask is None else jnp.asarray(mask))
    to = tep.assign_onehot(tcol, targ, None if mask is None else t(mask))
    np.testing.assert_array_equal(n(to), n(jo))
    assert int(to.sum()) == (30 if masked else d.shape[0])


@pytest.mark.parametrize("with_mask", [False, True])
def test_label_onehot_matches_reference(with_mask):
    rng = np.random.default_rng(5)
    labels = rng.integers(0, 9, size=50).astype(np.int32)   # 8 = padding
    mask = rng.random(50) < 0.7 if with_mask else None
    jo = jep.label_onehot(jnp.asarray(labels), 8,
                          None if mask is None else jnp.asarray(mask))
    to = tep.label_onehot(t(labels), 8, None if mask is None else t(mask))
    np.testing.assert_array_equal(n(to), n(jo))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_masked_fold_matches_reference(seed):
    """Fold four column tiles one after another: the running (val, idx)
    equals the reference's fold step by step, and ties keep the earlier
    tile."""
    d = _tile(seed, rows=17, cols=64, nan=False)
    tn = 16
    jstate = (jnp.full((17, 1), jnp.inf, jnp.float32),
              jnp.zeros((17, 1), jnp.int32))
    tstate = None
    for j in range(0, 64, tn):
        _, jmin, jarg = jep.iota_argmin(jnp.asarray(d[:, j:j + tn]), tn)
        _, tmin, targ = tep.iota_argmin(t(d[:, j:j + tn]), tn)
        jstate = jep.masked_fold_ref(*jstate, jmin, jarg, j)
        tstate = tep.masked_fold(tstate, tmin, targ, j)
        np.testing.assert_array_equal(n(tstate[0]), n(jstate[0]))
        np.testing.assert_array_equal(n(tstate[1]), n(jstate[1]))
    # the folded result is the global first minimum on NaN-free tiles
    np.testing.assert_array_equal(n(tstate[1])[:, 0], d.argmin(1))
