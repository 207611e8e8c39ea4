"""The port's compiled driver (raft_tpu_torch/runtime/compiled_driver.py)
and the chunked ``kmeans_fit`` against the reference package's, on the
CPU (where a chunk is a Python loop over the same step body; the
captured CUDA graphs run on the card, in ``chip_smoke.py``'s
``compiled_driver`` phase).

Mirrors the one-device cases of ``tests/test_compiled_driver.py``:
``chunk_while``'s early exit, the ``sync_every`` cost model, chunk
admission against a deadline, and ``kmeans_fit`` with ``sync_every`` 1
and 8 (plain and weighted). The same numpy inputs go through both
packages: centroids within 1e-5, ``n_iter`` and labels equal; the port's
``sync_every=8`` is bitwise its ``sync_every=1``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_util import both_tiers, n, t
from raft_tpu.cluster import kmeans as jk
from raft_tpu.core import trace as jtrace
from raft_tpu.runtime import compiled_driver as jcd
from raft_tpu.runtime import limits as jlim
from raft_tpu_torch import device_resources, kernels, obs
from raft_tpu_torch.cluster import kmeans as tk
from raft_tpu_torch.core import trace
from raft_tpu_torch.obs import metrics as obs_metrics
from raft_tpu_torch.runtime import compiled_driver as cd
from raft_tpu_torch.runtime import limits

RES = device_resources("cpu")


@pytest.fixture
def clean_events():
    trace.clear_events()
    yield
    trace.clear_events()


@pytest.fixture
def live_obs():
    was = obs.enabled()
    old = obs_metrics.set_registry(obs.MetricsRegistry())
    obs.set_enabled(True)
    try:
        yield obs_metrics.get_registry()
    finally:
        obs.set_enabled(was)
        obs_metrics.set_registry(old)


def _blobs(m=320, k=8, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=6.0, size=(5, k))
    return (centers[rng.integers(0, 5, m)]
            + rng.normal(size=(m, k))).astype(np.float32)


def _chunk_events(events):
    return [e for e in events if e["name"] == "compiled_driver.chunk"]


# -- chunk_while -------------------------------------------------------------


class TestChunkWhile:
    @pytest.mark.parametrize("stop,steps", [(3, 10), (20, 10), (1, 1),
                                            (5, 0)])
    def test_early_exit_counts_executions(self, stop, steps):
        @jax.jit
        def chunk(c, s):
            return jcd.chunk_while(lambda c: (c + 1, c + 1 >= stop), c, s)

        jc, jran, jdone = chunk(jnp.asarray(0), jnp.asarray(steps,
                                                            jnp.int32))
        tc, tran, tdone = cd.chunk_while(
            lambda c: (c + 1, c + 1 >= stop), torch.tensor(0), steps)
        assert (int(tc), int(tran), bool(tdone)) \
            == (int(jc), int(jran), bool(jdone))
        assert tran.dtype == torch.int32 and tdone.dtype == torch.bool

    def test_steps_serve_full_and_tail_chunks(self):
        for steps in (8, 3):
            _, ran, done = cd.chunk_while(
                lambda c: (c + 1, torch.tensor(False)), torch.tensor(0),
                steps)
            assert int(ran) == steps and not bool(done)

    def test_tuple_carry_and_negative_steps(self):
        (a, b), ran, _ = cd.chunk_while(
            lambda c: ((c[0] + 1, c[1] * 2), c[0] >= 2),
            (torch.tensor(0), torch.tensor(1.0)), 10)
        assert (int(a), float(b), int(ran)) == (3, 8.0, 3)
        with pytest.raises(ValueError, match="steps"):
            cd.chunk_while(lambda c: (c, True), torch.tensor(0), -1)


# -- the sync_every cost model ---------------------------------------------


class TestSyncEveryPolicy:
    def test_cpu_defaults_to_host_driven(self):
        assert cd.default_sync_every(backend="cpu") == 1
        assert cd.resolve_sync_every(None, backend="cpu") == 1
        assert cd.resolve_sync_every(None, device="cpu") == 1
        assert cd.resolve_sync_every(None, device=torch.device("cpu")) == 1

    @pytest.mark.parametrize("step_seconds", [None, 1.0, 1e-3, 1e-4, 1e-5,
                                              0.0])
    def test_card_clamped_8_16_as_the_reference(self, step_seconds):
        got = cd.default_sync_every(backend="gpu",
                                    step_seconds=step_seconds)
        assert got == jcd.default_sync_every(backend="gpu",
                                             step_seconds=step_seconds)
        assert cd.SYNC_EVERY_LO <= got <= cd.SYNC_EVERY_HI
        assert cd.resolve_sync_every(None, device="cuda:0",
                                     step_seconds=step_seconds) == got

    def test_tables_are_the_references_without_tpu(self):
        assert cd.DISPATCH_OVERHEAD_S == {
            k: v for k, v in jcd.DISPATCH_OVERHEAD_S.items() if k != "tpu"}
        assert (cd.SYNC_EVERY_LO, cd.SYNC_EVERY_HI) \
            == (jcd.SYNC_EVERY_LO, jcd.SYNC_EVERY_HI)
        assert cd.host_float_dtype() == torch.float64

    def test_explicit_value_validated(self):
        assert cd.resolve_sync_every(4) == jcd.resolve_sync_every(4) == 4
        for bad in (0, -3):
            with pytest.raises(ValueError):
                cd.resolve_sync_every(bad)

    def test_unchunked_callers_resolve_none_to_one(self, monkeypatch):
        """On the card the default is 16; the solvers whose chunks are
        queue item A13b (``kmeans_fit_mnmg``, Lanczos,
        ``pca_partial_fit``) must still take ``None`` as 1 there, and
        raise for an explicit value above 1."""
        from raft_tpu.core.sparse_types import CSRMatrix as JCSR
        from raft_tpu_torch import interop
        from raft_tpu_torch.cluster import KMeansParams, kmeans_fit_mnmg
        from raft_tpu_torch.linalg import pca_partial_fit
        from raft_tpu_torch.sparse.solver import lanczos as tl
        from raft_tpu_torch.util.input_validation import (expect_one_sync,
                                                          resolve_sync_every)
        import scipy.sparse as sp

        monkeypatch.setattr(cd, "default_sync_every", lambda **kw: 16)
        assert resolve_sync_every(None) == 16
        expect_one_sync(None, "op")
        expect_one_sync(1, "op")
        a = sp.random(40, 40, density=0.2, random_state=0, format="csr",
                      dtype=np.float32)
        j = JCSR.from_scipy(sp.csr_matrix((a + a.T) * 0.5))
        csr = interop.csr_from_numpy(np.asarray(j.indptr),
                                     np.asarray(j.indices),
                                     np.asarray(j.data), j.shape, res=RES)
        w, _ = tl.eigsh(csr, k=2, sync_every=None)
        assert w.shape == (2,)
        x = torch.as_tensor(_blobs(64, 6))
        state = pca_partial_fit(RES, x, sync_every=None)
        assert int(state.count) == 64
        with pytest.raises(NotImplementedError, match="13b"):
            tl.eigsh(csr, k=2, sync_every=4)
        with pytest.raises(NotImplementedError, match="13b"):
            pca_partial_fit(RES, x, sync_every=2)
        with pytest.raises(NotImplementedError, match="13b"):
            kmeans_fit_mnmg(RES, KMeansParams(n_clusters=2), x,
                            mesh=object(), sync_every=8)


# -- chunk admission and boundaries ----------------------------------------


class TestChunkBudget:
    @pytest.mark.parametrize("backend", ["cpu", "gpu"])
    def test_estimates_are_the_references(self, backend):
        for op, dims in (
                ("cluster.lloyd_step", dict(m=1000, k=64, n_clusters=32)),
                ("sparse.lanczos_restart", dict(n=1000, ncv=20, nnz=5000,
                                                 k=4)),
                ("linalg.gemm", dict(m=64, n=32, k=16, itemsize=4)),
                ("sparse.spmv", dict(n_rows=100, n_cols=90, nnz=700,
                                     itemsize=4))):
            got = limits.estimate_seconds(op, backend=backend, **dims)
            assert got > 0.0
            assert got == jlim.estimate_seconds(op, backend=backend, **dims)
            assert limits.estimate_flops_bytes(op, **dims) \
                == jlim.estimate_flops_bytes(op, **dims)

    def test_unknown_op_raises(self):
        with pytest.raises(ValueError, match="no seconds estimator"):
            limits.estimate_seconds("nope.unknown", backend="cpu", m=1)
        with pytest.raises(ValueError, match="no seconds estimator"):
            limits.estimate_flops_bytes("nope.unknown", m=1)

    def test_fast_fail_before_launch(self, clean_events):
        """A chunk whose estimate exceeds the remaining slack fails
        BEFORE launching (no chunk trace event), in both packages."""
        def chunk_call(carry, steps):     # pragma: no cover
            raise AssertionError("chunk launched past its budget")

        for lim, drv, tr, zero in ((limits, cd, trace, torch.zeros(())),
                                   (jlim, jcd, jtrace, jnp.zeros(()))):
            tr.clear_events()
            with lim.deadline_scope(1.0):
                with pytest.raises(lim.DeadlineExceededError):
                    drv.run_chunked(chunk_call, zero, max_steps=100,
                                    sync_every=10, op="test.budget",
                                    est_step_seconds=100.0)
            assert not _chunk_events(tr.events())

    def test_check_chunk_budget_without_deadline_is_noop(self):
        limits.check_chunk_budget("test.budget", 1e9)

    def test_slack_recorded_at_boundaries(self, clean_events, live_obs):
        def chunk(c, steps):
            return cd.chunk_while(lambda c: (c + 1, torch.tensor(False)),
                                  c, steps)

        with limits.deadline_scope(60.0):
            carry, done_steps, done = cd.run_chunked(
                chunk, torch.tensor(0), max_steps=8, sync_every=4,
                op="test.slack")
        assert (int(carry), done_steps, done) == (8, 8, False)
        snap = live_obs.snapshot()
        # one per chunk boundary (2 chunks of 4) plus the scope's exit
        assert snap["deadline_slack_seconds"]["series"][0]["count"] == 3
        assert [e["steps"] for e in _chunk_events(trace.events())] == [4, 4]

    def test_boundary_order_and_resumed_offset(self):
        seen = []

        def chunk(c, steps):
            return cd.chunk_while(lambda c: (c + 1, c + 1 >= 7), c, steps)

        carry, steps_done, done = cd.run_chunked(
            chunk, torch.tensor(2), max_steps=20, sync_every=3,
            op="test.offset", steps_done=2,
            boundary=lambda c, s, d: seen.append((int(c), s, d)))
        assert (int(carry), steps_done, done) == (7, 7, True)
        assert seen == [(2, 2, False), (5, 5, False), (7, 7, True)]


def test_capture_tally_counts_each_replay():
    """A launch recorded under capture goes to the tally; each replay
    counts the tally (the bookkeeping behind the kernels line)."""
    kernels.reset_launch_counts()
    with kernels.capture_launches() as tally:
        assert tally == {}
    tally["fused_lloyd"] = 2
    for _ in range(3):
        kernels.count_replay(tally)
    counts = kernels.launch_counts()
    assert counts["fused_lloyd"] == 6
    assert sum(counts.values()) == 6
    kernels.reset_launch_counts()


def test_graph_stats_and_clear():
    cd.reset_graph_stats()
    st = cd.graph_stats()
    assert st == {"captures": 0, "replays": 0, "steps_launched": 0,
                  "host_reads": 0}
    cd.run_chunked(lambda c, s: cd.chunk_while(
        lambda c: (c + 1, False), c, s), torch.tensor(0), max_steps=5,
        sync_every=2, op="test.reads")
    assert cd.graph_stats()["host_reads"] == 3
    cd.reset_graph_stats()
    assert cd.graph_stats()["host_reads"] == 0


def test_chunk_loop_is_chunk_while_across_chunks():
    """One ChunkLoop serves every chunk of a run (full and tail) and
    keeps its early exit; on the CPU it is chunk_while's Python loop."""
    loop = cd.ChunkLoop(lambda c: (c + 1, c + 1 >= 7))
    carry, steps_done, done = cd.run_chunked(
        loop, torch.tensor(0), max_steps=20, sync_every=3, op="test.loop")
    assert (int(carry), steps_done, done) == (7, 7, True)
    out, ran, fin = loop(torch.tensor(0), 2)
    assert (int(out), int(ran), bool(fin)) == (2, 2, False)


def test_gated_sets_the_gate_on_this_thread_only():
    """A masked step's gate: set under kernels.gated, 0 (a null gate)
    outside it and on other threads."""
    import threading

    assert kernels.gate_ptr() == 0
    flag = torch.ones((), dtype=torch.int32)
    seen = []
    with kernels.gated(flag):
        assert kernels.gate_ptr() == flag.data_ptr()
        th = threading.Thread(target=lambda: seen.append(kernels.gate_ptr()))
        th.start()
        th.join()
    assert seen == [0] and kernels.gate_ptr() == 0


# -- kmeans_fit in chunks ----------------------------------------------------


def _params(**kw):
    p = dict(n_clusters=5, seed=0, max_iter=25, init="array")
    p.update(kw)
    return p


def _init(x, k=5):
    return x[np.linspace(0, len(x) - 1, k).astype(int)].copy()


def _fit_both(x, p, sync, w=None, tier="high"):
    from raft_tpu_torch import interop

    init = _init(x, p["n_clusters"])
    jp = jk.KMeansParams(**{**p, "init": jk.KMeansInit.ARRAY})
    with both_tiers(tier):
        j = jk.kmeans_fit(None, jp, x, init, sample_weights=w,
                          sync_every=sync)
        tp = interop.kmeans_params_from_dict(p)
        tw = None if w is None else t(w)
        out = {s: tk.kmeans_fit(None, tp, t(x), t(init), sample_weights=tw,
                                sync_every=s) for s in (1, sync)}
    return j, out


class TestKMeansChunked:
    @pytest.mark.parametrize("tier", ["high", "highest"])
    def test_sync1_is_the_host_loop(self, clean_events, tier):
        x = _blobs()
        j, out = _fit_both(x, _params(), 1, tier=tier)
        with both_tiers(tier):                  # default: cpu -> 1
            c0, i0, l0, n0 = tk.kmeans_fit(
                None, tk.KMeansParams(n_clusters=5, max_iter=25,
                                      init=tk.KMeansInit.ARRAY),
                t(x), t(_init(x)))
        c1, i1, l1, n1 = out[1]
        assert torch.equal(c0, c1) and torch.equal(l0, l1) and n0 == n1
        assert float(i0) == float(i1)
        assert not _chunk_events(trace.events())
        assert n1 == j[3]
        np.testing.assert_array_equal(n(l1), n(j[2]))
        np.testing.assert_allclose(n(c1), n(j[0]), rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("tier", ["high", "highest", "default"])
    @pytest.mark.parametrize("sync", [8, 3])
    def test_chunked_matches_reference_and_is_bitwise_sync1(self, tier,
                                                            sync):
        x = _blobs()
        j, out = _fit_both(x, _params(), sync, tier=tier)
        (c1, i1, l1, n1), (cs, is_, ls, ns) = out[1], out[sync]
        assert torch.equal(c1, cs) and torch.equal(l1, ls) and n1 == ns
        assert float(i1) == float(is_)
        if tier == "default":
            return     # one bf16 pass: the inertias' roundings differ
        assert ns == j[3]
        np.testing.assert_array_equal(n(ls), n(j[2]))
        np.testing.assert_allclose(n(cs), n(j[0]), rtol=1e-5, atol=1e-5)

    def test_weighted_chunked(self):
        x = _blobs()
        w = np.random.default_rng(3).uniform(0.5, 2.0,
                                             x.shape[0]).astype(np.float32)
        j, out = _fit_both(x, _params(), 8, w=w)
        (c1, _, l1, n1), (c8, _, l8, n8) = out[1], out[8]
        assert torch.equal(c1, c8) and torch.equal(l1, l8) and n1 == n8
        assert n8 == j[3]
        np.testing.assert_array_equal(n(l8), n(j[2]))
        np.testing.assert_allclose(n(c8), n(j[0]), rtol=1e-5, atol=1e-5)

    def test_host_sync_count_is_chunk_count(self, clean_events, live_obs):
        """32 never-converging iterations at sync_every=8 touch the host
        exactly ceil(32/8) = 4 times."""
        x = _blobs()
        p = tk.KMeansParams(n_clusters=5, max_iter=32, tol=-1.0,
                            init=tk.KMeansInit.ARRAY)
        with pytest.warns(RuntimeWarning, match="not converged"):
            _, _, _, n_iter = tk.kmeans_fit(None, p, t(x), t(_init(x)),
                                            sync_every=8)
        assert n_iter == 32
        ev = _chunk_events(trace.events())
        assert len(ev) == math.ceil(32 / 8)
        assert sum(e["steps"] for e in ev) == 32
        series = live_obs.snapshot()["solver_host_syncs_total"]["series"]
        counts = {tuple(s["labels"].items()): s["value"] for s in series}
        assert counts[(("op", "cluster.kmeans_fit"),)] == 4

    def test_convergence_report_and_metrics(self, live_obs):
        x = _blobs()
        p = tk.KMeansParams(n_clusters=5, max_iter=25,
                            init=tk.KMeansInit.ARRAY)
        *_, rep = tk.kmeans_fit(None, p, t(x), t(_init(x)), sync_every=8,
                                return_report=True)
        *_, jrep = jk.kmeans_fit(
            None, jk.KMeansParams(n_clusters=5, max_iter=25,
                                  init=jk.KMeansInit.ARRAY), x, _init(x),
            sync_every=8, return_report=True)
        assert (rep.converged, rep.n_iter) == (jrep.converged, jrep.n_iter)
        # a difference of two inertias that agree to ~1e-7 relative
        assert rep.residual == pytest.approx(jrep.residual, abs=1e-5)
        snap = live_obs.snapshot()
        runs = snap["solver_runs_total"]["series"]
        assert any(s["labels"]["solver"] == "cluster.kmeans_fit"
                   for s in runs)
        assert "solver_residual" in snap


# -- runtime.solver / runtime.random_gen --------------------------------------


@pytest.mark.parametrize("idx,val", [(np.int32, np.float32),
                                     (np.int64, np.float64)])
def test_lanczos_solver_matches_reference(idx, val):
    import scipy.sparse as sp

    from raft_tpu.runtime import solver as jsolver
    from raft_tpu.sparse.solver.lanczos import LanczosConfig as JConfig
    from raft_tpu_torch.runtime import solver
    from raft_tpu_torch.sparse.solver.lanczos import LanczosConfig

    a = sp.random(60, 60, density=0.1, random_state=2, format="csr")
    a = sp.csr_matrix((a + a.T) * 0.5 + sp.eye(60) * 2.0)
    rows, cols, vals = (a.indptr.astype(idx), a.indices.astype(idx),
                        a.data.astype(val))
    v0 = np.random.default_rng(0).normal(size=60).astype(val)
    cfg = dict(n_components=3, max_iterations=200, tolerance=1e-7)
    jw, _ = jsolver.lanczos_solver(None, JConfig(**cfg), rows, cols, vals,
                                   v0=v0)
    tw, tv = solver.lanczos_solver(RES, LanczosConfig(**cfg), rows, cols,
                                   vals, v0=torch.as_tensor(v0))
    want = np.sort(np.linalg.eigvalsh(a.toarray()))[:3]
    # both packages give f32 eigenvalues for either value dtype
    np.testing.assert_allclose(n(tw), np.asarray(jw), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(n(tw), want, rtol=1e-5, atol=1e-5)
    assert tv.shape == (60, 3)


def test_runtime_entry_points_reject_other_dtypes():
    from raft_tpu_torch.random import RngState
    from raft_tpu_torch.runtime import random_gen, solver
    from raft_tpu_torch.sparse.solver.lanczos import LanczosConfig

    cfg = LanczosConfig(n_components=1)
    rows = np.array([0, 1, 2], np.int32)
    cols = np.array([0, 1], np.int32)
    with pytest.raises(TypeError, match="index dtype"):
        solver.lanczos_solver(RES, cfg, rows.astype(np.int16), cols,
                              np.ones(2, np.float32))
    with pytest.raises(TypeError, match="value dtype"):
        solver.lanczos_solver(RES, cfg, rows, cols, np.ones(2, np.float16))
    for dtype in (np.int32, np.int64, torch.int32, torch.int64):
        src, dst = random_gen.rmat_rectangular_gen(
            RES, RngState(3), None, 5, 4, 200, out_dtype=dtype)
        want = torch.int64 if dtype in (np.int64, torch.int64) \
            else torch.int32
        assert src.dtype == dst.dtype == want and src.shape == (200,)
        assert int(src.max()) < 32 and int(dst.max()) < 16
    theta = np.tile([0.5, 0.2, 0.2, 0.1], (5, 1))
    src, _ = random_gen.rmat_rectangular_gen(RES, RngState(3), theta, 5, 5,
                                             100)
    assert src.shape == (100,)
    for bad in (np.float32, torch.int16, "int8"):
        with pytest.raises(TypeError, match="index dtype"):
            random_gen.rmat_rectangular_gen(RES, RngState(3), None, 5, 4,
                                            10, out_dtype=bad)
