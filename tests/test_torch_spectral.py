"""The port's spectral drivers and analyzers (raft_tpu_torch.spectral)
against the reference's, on the fixtures of tests/test_spectral_partition.py
(the ring of cliques, the karate club), CPU tensors.

The k-means++ seeding draws from different generators in the two
packages, so labels are compared up to a permutation of the cluster ids.
The analyzers are deterministic functions of the labels and agree within
1e-5 (relative) on the same labels.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from _torch_util import n, t
from raft_tpu import spectral as js
from raft_tpu.core.sparse_types import CSRMatrix as JCSR
from raft_tpu_torch import device_resources, interop, kernels
from raft_tpu_torch import spectral as ts
from tests.conftest import ring_of_cliques
from tests.test_spectral_partition import _FACTION, _KARATE_EDGES


def _karate():
    src, dst = np.asarray(_KARATE_EDGES).T
    a = sp.coo_matrix((np.ones(len(src), np.float32), (src, dst)),
                      shape=(34, 34))
    return JCSR.from_scipy((a + a.T).tocsr())


def _port(j):
    return interop.csr_from_numpy(np.asarray(j.indptr), np.asarray(j.indices),
                                  np.asarray(j.data), j.shape,
                                  res=device_resources("cpu"))


def _same_partition(a, b):
    """Equal up to a bijection of the label values."""
    a, b = np.asarray(a), np.asarray(b)
    fwd, bwd = {}, {}
    for x, y in zip(a.tolist(), b.tolist()):
        if fwd.setdefault(x, y) != y or bwd.setdefault(y, x) != x:
            return False
    return True


GRAPHS = {"ring_of_cliques": (ring_of_cliques, 4, 1),
          "karate": (_karate, 2, 3)}


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_partition_matches_reference(graph):
    make, k, seed = GRAPHS[graph]
    j = make()
    jlab, jvals, _ = js.partition(None, j, n_clusters=k, seed=seed)
    kernels.reset_launch_counts()
    tlab, tvals, tvecs = ts.partition(None, _port(j), n_clusters=k,
                                      seed=seed)
    assert set(kernels.launch_counts().values()) == {0}     # CPU: plain
    assert _same_partition(n(tlab), jlab)
    np.testing.assert_allclose(n(tvals), np.asarray(jvals), rtol=1e-4,
                               atol=1e-4)
    assert tvecs.shape == (j.shape[0], k)
    if graph == "karate":
        agree = (n(tlab) == _FACTION).mean()
        assert max(agree, 1 - agree) >= 0.85


@pytest.mark.parametrize("normalized", [True, False])
def test_partition_unnormalized_and_scipy_input(normalized):
    j = ring_of_cliques()
    jlab, _, _ = js.partition(None, j, n_clusters=4, seed=2,
                              normalized=normalized)
    tlab, tvals, _, report = ts.partition(
        device_resources("cpu"), j.to_scipy(), n_clusters=4, seed=2,
        normalized=normalized, return_report=True)
    assert _same_partition(n(tlab), jlab)
    assert len(set(n(tlab).tolist())) == 4
    # the report is the eigensolve's own; asking for it changes nothing
    assert report.converged and report.n_iter >= 1
    _, plain_vals, _ = ts.partition(device_resources("cpu"), j.to_scipy(),
                                    n_clusters=4, seed=2,
                                    normalized=normalized)
    np.testing.assert_array_equal(n(tvals), n(plain_vals))


@pytest.mark.parametrize("seed", [0, 1, 3])
def test_modularity_maximization_matches_reference(seed):
    """The 2-means on the row-normalized 2-D embedding (points on a
    circle) has several local optima, and which one a seed reaches
    depends on the k-means++ draws, whose generators differ: at seeds 2,
    5 and 6 the packages reach different optima (the reference itself
    reaches modularity 0.218 at seed 6, 0.371 elsewhere). These seeds
    reach the same one in both."""
    j = _karate()
    jlab, jvals, _ = js.modularity_maximization(None, j, n_clusters=2,
                                                seed=seed)
    tlab, tvals, _ = ts.modularity_maximization(None, _port(j),
                                                n_clusters=2, seed=seed)
    assert _same_partition(n(tlab), jlab)
    np.testing.assert_allclose(n(tvals), np.asarray(jvals), rtol=1e-4,
                               atol=1e-5)
    q = float(ts.analyze_modularity(None, _port(j), 2, tlab))
    assert q > 0.3


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("labels", ["truth", "random", "one_empty"])
def test_analyzers_match_reference(graph, labels):
    make, k, _ = GRAPHS[graph]
    j = make()
    size = j.shape[0]
    rng = np.random.default_rng(7)
    lab = {"truth": (np.arange(size) // 8 % k if graph == "ring_of_cliques"
                     else _FACTION),
           "random": rng.integers(0, k, size),
           "one_empty": rng.integers(0, k, size) % max(k - 1, 1)}[labels]
    lab = lab.astype(np.int32)
    kk = k + (labels == "one_empty")
    jcut, jcost = js.analyze_partition(None, j, kk, lab)
    tcut, tcost = ts.analyze_partition(None, _port(j), kk, t(lab))
    np.testing.assert_allclose(float(tcut), float(jcut), rtol=1e-5)
    np.testing.assert_allclose(float(tcost), float(jcost), rtol=1e-5)
    jq = js.analyze_modularity(None, j, kk, lab)
    tq = ts.analyze_modularity(None, _port(j), kk, t(lab))
    np.testing.assert_allclose(float(tq), float(jq), rtol=1e-5, atol=1e-7)
    assert tcut.dtype == torch.float32
