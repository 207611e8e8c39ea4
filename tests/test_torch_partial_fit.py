"""The port's minibatch k-means (``raft_tpu_torch.cluster.kmeans
.kmeans_partial_fit``) against the reference package's, on the CPU.

The same numpy centroids and batches go through both: counts equal,
centroids within 1e-5 (the one-hot sums differ in accumulation order).
Cold starts, ``counts`` threaded through two batches, a tail chunk (rows
not a multiple of ``chunk_rows``), the validation errors, and the
``kmeans_pf`` checkpoints: a mid-batch resume is bitwise the
uninterrupted port run, as ``tests/test_durability.py`` holds the
reference, and a checkpoint the reference wrote resumes in the port.
"""

import os

import numpy as np
import pytest
import torch

from _torch_util import both_tiers, n, t
from raft_tpu.cluster import kmeans as jk
from raft_tpu_torch import device_resources
from raft_tpu_torch.cluster import kmeans as tk
from raft_tpu_torch.core import trace
from raft_tpu_torch.core.checkpoint import restore_checkpoint

RES = device_resources("cpu")


def _data(k=4, d=6, rows=64, seed=5):
    rng = np.random.default_rng(seed)
    c0 = rng.normal(size=(k, d)).astype(np.float32)
    batch = rng.normal(size=(rows, d)).astype(np.float32)
    return c0, batch


def _close(got, want):
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("tier", ["high", "highest"])
@pytest.mark.parametrize("rows,chunk_rows", [(64, 8), (67, 8), (50, 256),
                                             (33, 1)])
def test_cold_pass_matches_reference(tier, rows, chunk_rows):
    c0, batch = _data(rows=rows)
    with both_tiers(tier):
        jc, jn = jk.kmeans_partial_fit(None, c0, batch,
                                       chunk_rows=chunk_rows)
        tc, tn = tk.kmeans_partial_fit(RES, t(c0), t(batch),
                                       chunk_rows=chunk_rows)
    np.testing.assert_array_equal(n(tn), np.asarray(jn))
    assert float(tn.sum()) == rows
    _close(tc, jc)
    assert tc.dtype == torch.float32 and tn.dtype == torch.float32


def test_counts_threaded_through_two_batches():
    c0, b1 = _data(rows=40, seed=1)
    _, b2 = _data(rows=56, seed=2)
    jc, jn = jk.kmeans_partial_fit(None, c0, b1, chunk_rows=16)
    jc, jn = jk.kmeans_partial_fit(None, jc, b2, counts=jn, chunk_rows=16)
    tc, tn = tk.kmeans_partial_fit(RES, t(c0), t(b1), chunk_rows=16)
    tc, tn = tk.kmeans_partial_fit(RES, tc, t(b2), counts=tn,
                                   chunk_rows=16)
    np.testing.assert_array_equal(n(tn), np.asarray(jn))
    assert float(tn.sum()) == 96
    _close(tc, jc)


@pytest.mark.parametrize("sync", [2, 3, 16])
def test_chunked_is_bitwise_one_step_chunks(sync):
    c0, batch = _data(rows=75)
    a = tk.kmeans_partial_fit(RES, t(c0), t(batch), chunk_rows=8,
                              sync_every=1)
    b = tk.kmeans_partial_fit(RES, t(c0), t(batch), chunk_rows=8,
                              sync_every=sync)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_numpy_inputs_follow_the_handle_and_trace_event():
    c0, batch = _data(rows=40)
    trace.clear_events()
    tc, tn = tk.kmeans_partial_fit(RES, c0, batch, chunk_rows=16)
    assert tc.device.type == "cpu"
    ev = [e for e in trace.events() if e["name"] == "kmeans.partial_fit"]
    assert len(ev) == 1
    assert {k: ev[0][k] for k in ("rows", "n_clusters", "chunks",
                                  "chunk_rows")} \
        == {"rows": 40, "n_clusters": 4, "chunks": 3, "chunk_rows": 16}
    trace.clear_events()


def test_validation_errors_match_reference():
    c0, batch = _data()
    cases = [
        (dict(centroids=c0[0], batch=batch), "centroids"),
        (dict(centroids=c0, batch=batch[:, :3]), "batch"),
        (dict(centroids=c0, batch=batch[:0]), "at least one row"),
        (dict(centroids=c0, batch=batch, chunk_rows=0), "chunk_rows"),
        (dict(centroids=c0, batch=batch, counts=np.ones(3, np.float32)),
         "counts"),
        (dict(centroids=c0, batch=batch, checkpoint_every=1),
         "checkpoint_dir"),
    ]
    for kw, match in cases:
        with pytest.raises(ValueError, match=match):
            jk.kmeans_partial_fit(None, **kw)
        tkw = dict(kw, centroids=t(kw["centroids"]), batch=t(kw["batch"]))
        with pytest.raises(ValueError, match=match):
            tk.kmeans_partial_fit(RES, **tkw)


def _saved(ck):
    return sorted(f for f in os.listdir(ck) if f.startswith("kmeans_pf-"))


def test_resume_is_bitwise_the_uninterrupted_run(tmp_path):
    c0, batch = _data()
    ref_c, ref_n = tk.kmeans_partial_fit(RES, t(c0), t(batch),
                                         chunk_rows=8)
    ck = str(tmp_path / "pf")
    full = tk.kmeans_partial_fit(RES, t(c0), t(batch), chunk_rows=8,
                                 sync_every=2, checkpoint_dir=ck,
                                 checkpoint_every=1, checkpoint_keep=16)
    assert torch.equal(full[0], ref_c) and torch.equal(full[1], ref_n)
    saved = _saved(ck)
    assert saved == [f"kmeans_pf-{i:08d}.ckpt" for i in (2, 4, 6, 8)]
    for name in saved[:-1]:
        mid = os.path.join(ck, name)
        chunk = int(restore_checkpoint(mid)["chunk"])
        assert 0 < chunk < 8
        out_c, out_n = tk.kmeans_partial_fit(RES, t(c0), t(batch),
                                             chunk_rows=8, resume_from=mid)
        assert torch.equal(out_c, ref_c) and torch.equal(out_n, ref_n)
    # a directory resumes from its newest checkpoint: the end of the batch
    out_c, out_n = tk.kmeans_partial_fit(RES, t(c0), t(batch), chunk_rows=8,
                                         resume_from=ck)
    assert torch.equal(out_c, ref_c) and torch.equal(out_n, ref_n)


def test_resume_beyond_batch_raises(tmp_path):
    c0, batch = _data()
    ck = str(tmp_path / "pf")
    tk.kmeans_partial_fit(RES, t(c0), t(batch), chunk_rows=8,
                          checkpoint_dir=ck, checkpoint_every=1)
    newest = os.path.join(ck, _saved(ck)[-1])
    with pytest.raises(ValueError, match="SAME batch"):
        tk.kmeans_partial_fit(RES, t(c0), t(batch[:16]), chunk_rows=8,
                              resume_from=newest)


def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    """A ``kmeans_pf`` checkpoint written by the reference's pass, cut
    mid-batch, finishes in the port within tolerance of the reference's
    uninterrupted pass."""
    c0, batch = _data(rows=72)
    ref_c, ref_n = jk.kmeans_partial_fit(None, c0, batch, chunk_rows=8)
    ck = str(tmp_path / "ref_pf")
    jk.kmeans_partial_fit(None, c0, batch, chunk_rows=8, checkpoint_dir=ck,
                          checkpoint_every=1, checkpoint_keep=16)
    mid = os.path.join(ck, _saved(ck)[3])
    assert 0 < int(restore_checkpoint(mid)["chunk"]) < 9
    out_c, out_n = tk.kmeans_partial_fit(RES, t(c0), t(batch), chunk_rows=8,
                                         resume_from=mid)
    np.testing.assert_array_equal(n(out_n), np.asarray(ref_n))
    _close(out_c, ref_c)
