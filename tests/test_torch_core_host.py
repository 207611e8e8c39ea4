"""The port's host core against the reference package: memory types, the
handle's resource registry, mdarray, ``.npy`` serialization and the
memory observability layer, on the same numpy inputs made from a seed.

Exact throughout: serialized bytes, layouts' raw buffers, registry
defaults, error types and messages. The reference modules are imported
in a fixture, so the card tests at the end run where JAX is absent
(``-m cuda --noconftest``).
"""

import io
import threading
import types

import numpy as np
import pytest
import torch

from raft_tpu_torch import interop
from raft_tpu_torch.core import mdarray as tmd
from raft_tpu_torch.core import memory as tmem
from raft_tpu_torch.core import memory_type as tmt
from raft_tpu_torch.core import resources as tres
from raft_tpu_torch.core import serialize as tser
from raft_tpu_torch.core.interruptible import InterruptedException

SEED = 16
GRID = [np.float32, np.float64, np.int32, np.int64, np.uint8, np.bool_,
        np.float16]


@pytest.fixture(scope="module")
def ref():
    from raft_tpu.core import mdarray, memory, memory_type, resources, \
        serialize

    return types.SimpleNamespace(md=mdarray, mem=memory, mt=memory_type,
                                 res=resources, ser=serialize)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _grid_array(dtype, shape=(6, 7)):
    rng = np.random.default_rng(SEED)
    if dtype == np.bool_:
        return rng.uniform(size=shape) < 0.5
    if np.issubdtype(dtype, np.floating):
        return rng.normal(size=shape).astype(dtype)
    return rng.integers(0, 100, size=shape).astype(dtype)


# -- memory types --------------------------------------------------------------

def test_memory_types_and_traits_match(ref):
    assert [m.value for m in tmt.MemoryType] == \
        [m.value for m in ref.mt.MemoryType]
    for m in tmt.MemoryType:
        r = ref.mt.MemoryType(m.value)
        assert m.is_device_accessible == r.is_device_accessible
        assert m.is_host_accessible == r.is_host_accessible
    assert tmt.MANAGED.is_device_accessible and tmt.MANAGED.is_host_accessible


# -- the registry ----------------------------------------------------------------

def test_resource_slots_match(ref):
    assert [(s.name, s.value) for s in tres.ResourceType] == \
        [(s.name, s.value) for s in ref.res.ResourceType]


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_registry_builds_lazily_once_and_copies_share(ref, pkg):
    mod = tres if pkg == "port" else ref.res
    calls = []
    r = mod.Resources()
    key = mod.ResourceType.LOGGER
    r.add_resource_factory(mod.ResourceFactory(
        key, lambda: calls.append(1) or len(calls)))
    assert calls == []
    assert r.get_resource(key) == 1 and r.get_resource(key) == 1
    copy = mod.Resources(r)
    assert copy.get_resource(key) == 1 and calls == [1]
    r.add_resource_factory(mod.ResourceFactory(key, lambda: 7))
    assert copy.get_resource(key) == 7
    with pytest.raises(KeyError):
        r.get_resource(mod.ResourceType.DONATION)


def test_accessors_match_the_reference_defaults(ref):
    h = tres.device_resources("cpu", seed=3)
    rh = ref.res.device_resources(seed=3)
    assert isinstance(h, tres.Resources) and tres.Handle is tres.DeviceResources
    assert tres.get_device(h) == h.device == torch.device("cpu")
    assert tres.get_workspace_limit(h) == ref.res.get_workspace_limit(rh)
    tres.set_workspace_limit(h, 12345)
    ref.res.set_workspace_limit(rh, 12345)
    assert tres.get_workspace_limit(h) == ref.res.get_workspace_limit(rh)
    assert tres.get_rng_state(h).seed == ref.res.get_rng_state(rh).seed == 3
    fresh, rfresh = tres.Resources(), ref.res.Resources()
    assert tres.get_rng_state(fresh).seed == \
        ref.res.get_rng_state(rfresh).seed == 0
    for mod, handle in ((tres, h), (ref.res, rh)):
        with pytest.raises(KeyError):
            mod.get_subcomm(handle, "row")
        mod.set_subcomm(handle, "row", "the-row-comms")
        assert mod.get_subcomm(handle, "row") == "the-row-comms"
        with pytest.raises(RuntimeError):
            mod.get_comms(handle)
        assert not mod.comms_initialized(handle)
        assert mod.get_cancel_token(handle) is mod.get_cancel_token(handle)
    # the handle's members every ported module calls
    assert h.stream is None and h.comms is None
    assert isinstance(h.generator(), torch.Generator)
    other = tres.DeviceResources(other=h)
    assert other.device == h.device and other.rng_state is h.rng_state


def test_memory_stats_keys_and_cpu_zeros(ref):
    h = tres.device_resources("cpu")
    stats = tres.get_memory_stats(h)
    assert set(stats) == set(ref.mem.device_memory_stats())
    assert stats == {k: 0 for k in stats}


def test_sync_polls_the_handle_token():
    h = tres.device_resources("cpu")
    tres.sync(h, torch.zeros(3))
    tres.get_cancel_token(h).cancel()
    with pytest.raises(InterruptedException):
        h.sync_stream()
    h.sync_stream()     # the flag was consumed


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without CUDA")
    with pytest.raises(tres.DeviceUnavailableError):
        tres.device_resources()
    with pytest.raises(tres.DeviceUnavailableError):
        tres.get_device(tres.Resources())
    with pytest.raises(tres.DeviceUnavailableError):
        tres.get_device_resources()


def test_manager_caches_per_device_and_thread():
    mgr = tres.DeviceResourcesManager()
    mgr.set_seed(9)
    mgr.set_workspace_limit(1 << 20)
    a = mgr.get_device_resources("cpu")
    assert mgr.get_device_resources("cpu") is a
    assert a.rng_state.seed == 9 and tres.get_workspace_limit(a) == 1 << 20
    got = []
    t = threading.Thread(target=lambda: got.append(
        mgr.get_device_resources("cpu")))
    t.start()
    t.join(30)
    assert not t.is_alive() and got[0] is not a
    assert tres.get_device_resources("cpu") is tres.get_device_resources(
        "cpu")


def test_snmg_over_a_one_rank_world():
    import torch.distributed as dist

    from raft_tpu_torch.comms import perform_test_comms_allreduce

    assert not dist.is_initialized()
    with pytest.raises(ValueError):
        tres.DeviceResourcesSNMG(devices=[])
    try:
        snmg = tres.DeviceResourcesSNMG(devices=["cpu"])
        assert snmg.n_ranks == 1 and snmg.device == torch.device("cpu")
        for rank, child in enumerate(snmg):
            view = tres.get_comms(child)
            assert (view.get_rank(), view.get_size()) == (rank, 1)
        assert tres.get_comms(snmg).get_rank() == 0
        assert perform_test_comms_allreduce(
            tres.get_comms(snmg.rank_resources(0)))
        snmg.set_memory_pool(80)
        with pytest.raises(ValueError, match="one rank"):
            tres.DeviceResourcesSNMG(devices=["cpu", "cpu"])
    finally:
        dist.destroy_process_group()


# -- mdarray --------------------------------------------------------------------

def test_host_factories_match(ref):
    cases = [
        (tmd.make_host_matrix(3, 4), ref.md.make_host_matrix(3, 4)),
        (tmd.make_host_vector(5, np.int32),
         ref.md.make_host_vector(5, np.int32)),
        (tmd.make_host_scalar(2.5), ref.md.make_host_scalar(2.5)),
        (tmd.make_pinned_matrix(2, 3), ref.md.make_pinned_matrix(2, 3)),
    ]
    for got, want in cases:
        assert got.shape == want.shape and got.size == want.size
        assert got.memory_type.value == want.memory_type.value
        assert got.layout == want.layout
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        assert np.asarray(got).dtype == np.asarray(want).dtype
        assert got.data.device.type == "cpu"


def test_device_factories_on_the_handle_device():
    h = tres.device_resources("cpu")
    m = tmd.make_device_matrix(h, 3, 2, torch.float64, tmd.COL_MAJOR)
    assert (m.shape, m.dtype, m.layout) == ((3, 2), torch.float64,
                                            tmd.COL_MAJOR)
    assert m.memory_type is tmt.DEVICE and m.extent(1) == 2
    assert float(tmd.make_device_scalar(h, 4).data) == 4.0
    assert tmd.make_managed_matrix(h, 2, 2).memory_type.is_host_accessible
    assert tmd.make_device_mdarray(h, (2, 3, 4)).size == 24
    if not torch.cuda.is_available():
        with pytest.raises(tres.DeviceUnavailableError):
            tmd.make_device_vector(None, 4)


@pytest.mark.parametrize("to_layout", ["col_major", "row_major"])
def test_layout_copy_raw_buffers_match(ref, to_layout):
    """The buffers themselves, not only the values: a COL_MAJOR buffer
    holds A^T contiguously under A's shape."""
    a = np.arange(12, dtype=np.float32).reshape(3, 4) * 1.5
    from_layout = "row_major" if to_layout == "col_major" else "col_major"
    rsrc = ref.md.MdArray(a, ref.mt.HOST, from_layout)
    rdst = ref.md.make_host_matrix(3, 4, np.float64, layout=to_layout)
    ref.md.copy(None, rdst, rsrc)
    src = interop.mdarray_from_numpy(a, ref.mt.HOST, from_layout)
    dst = tmd.make_host_matrix(3, 4, torch.float64, layout=to_layout)
    tmd.copy(None, dst, src)
    assert dst.data.dtype == torch.float64 and dst.layout == to_layout
    np.testing.assert_array_equal(dst.data.numpy(), np.asarray(rdst.data))


def test_interop_keeps_memory_type_and_layout(ref):
    a = np.arange(6, dtype=np.int32).reshape(2, 3)
    h = tres.device_resources("cpu")
    for mt in ref.mt.MemoryType:
        m = interop.mdarray_from_numpy(a, mt, "col_major", res=h)
        assert m.memory_type.value == mt.value and m.layout == "col_major"
        np.testing.assert_array_equal(m.data.numpy(), a)


def test_mdbuffer_views(ref):
    h = tres.device_resources("cpu")
    src = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    buf = tmd.MdBuffer(src, res=h)
    rbuf = ref.md.MdBuffer(src.numpy())
    assert buf.memory_type.value == rbuf.memory_type.value == "host"
    assert buf.view() is src
    v = buf.view(dtype=torch.float64)
    assert v.dtype == torch.float64 and buf.view(dtype=np.float64) is v
    for mt in tmt.MemoryType:
        assert buf.is_copy_required(mt) == rbuf.is_copy_required(
            ref.mt.MemoryType(mt.value))
    assert buf.view(tmt.DEVICE).device == h.device
    assert tmd.MdBuffer(tmd.make_host_vector(4)).memory_type is tmt.HOST
    assert tmd.temporary_device_buffer(h, np.ones(3)).device == h.device


# -- serialize ------------------------------------------------------------------

@pytest.mark.parametrize("dtype", GRID)
def test_npy_bytes_match_for_the_dtype_grid(ref, dtype):
    a = _grid_array(dtype)
    want = ref.ser.dumps(a)
    assert tser.dumps(a) == want
    assert tser.dumps(torch.from_numpy(a)) == want
    back = tser.loads(want, to_device=False)
    assert back.dtype == a.dtype
    np.testing.assert_array_equal(back, a)
    t = tser.loads(want, res=tres.device_resources("cpu"))
    assert isinstance(t, torch.Tensor)
    np.testing.assert_array_equal(t.numpy(), a)


def test_bf16_wire_matches(ref):
    import ml_dtypes

    bits = np.random.default_rng(SEED).integers(0, 1 << 16, (5, 3),
                                                dtype=np.uint16)
    bits[bits & 0x7F80 == 0x7F80] = 0      # no inf/NaN patterns
    want = ref.ser.dumps(bits.view(ml_dtypes.bfloat16))
    t = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    assert tser.dumps(t) == want
    assert tser.dumps(bits.view(ml_dtypes.bfloat16)) == want
    back = tser.loads(want, to_device=False)
    assert back.dtype == torch.bfloat16
    assert torch.equal(back.view(torch.int16), t.view(torch.int16))
    rback = ref.ser.loads(tser.dumps(t), to_device=False)
    np.testing.assert_array_equal(np.asarray(rback).view(np.uint16), bits)


def test_fortran_input_and_scalars_match(ref):
    a = np.asfortranarray(np.arange(12, dtype=np.float32).reshape(3, 4))
    assert tser.dumps(a) == ref.ser.dumps(a)
    # a transposed tensor is written in C order, as a device array is
    t = torch.arange(12, dtype=torch.float32).reshape(4, 3).t()
    assert tser.dumps(t) == ref.ser.dumps(np.ascontiguousarray(t.numpy()))
    for v in (3, 2.5, True):
        buf, rbuf = io.BytesIO(), io.BytesIO()
        tser.serialize_scalar(None, buf, v)
        ref.ser.serialize_scalar(None, rbuf, v)
        assert buf.getvalue() == rbuf.getvalue()
        buf.seek(0)
        got = tser.deserialize_scalar(None, buf)
        assert got == v and type(got) is type(v)
    if not torch.cuda.is_available():
        with pytest.raises(tres.DeviceUnavailableError):
            tser.loads(tser.dumps(a))


# -- memory -------------------------------------------------------------------

def test_trackers_match(ref):
    events, revents = [], []
    t, r = tmem.NotifyingTracker(), ref.mem.NotifyingTracker()
    t.subscribe(lambda *e: events.append(e))
    r.subscribe(lambda *e: revents.append(e))
    for op, n in (("a", 100), ("a", 50), ("d", 100), ("a", 7), ("d", 50)):
        for tr in (t, r):
            (tr.on_alloc if op == "a" else tr.on_dealloc)(n)
        assert t.snapshot() == r.snapshot()
    assert events == revents


def test_device_memory_stats_without_a_card(ref):
    assert tmem.device_memory_stats("cpu") == ref.mem.device_memory_stats()
    if not torch.cuda.is_available():
        with pytest.raises(tres.DeviceUnavailableError):
            tmem.device_memory_stats()


def test_resource_monitor_csv(ref, tmp_path):
    from raft_tpu_torch.core import trace

    tracker = tmem.StatisticsTracker()
    tracker.on_alloc(4096)
    path = tmp_path / "mon.csv"
    with trace.push_range("staging"):
        mon = tmem.ResourceMonitor(str(path), tracker, interval_s=0.01,
                                   device="cpu")
    with mon:
        with pytest.raises(RuntimeError):
            mon.start()
        deadline = threading.Event()
        deadline.wait(0.1)
    rpath = tmp_path / "ref.csv"
    with ref.mem.ResourceMonitor(str(rpath), interval_s=0.01):
        threading.Event().wait(0.05)
    lines = path.read_text().splitlines()
    assert lines[0] == rpath.read_text().splitlines()[0]
    assert len(lines) >= 2
    row = lines[1].split(",")
    assert row[2:] == ["4096", "4096", "0", "0"]


def test_mmap_buffer(tmp_path):
    with tmem.mmap_buffer(64, dir=str(tmp_path)) as buf:
        a = buf.as_array(np.float32, (4, 4))
        a[:] = 3.0
        assert float(buf.as_array(np.float32).sum()) == 48.0
        assert list(tmp_path.iterdir()) == []
    buf.close()


# -- on the card ----------------------------------------------------------------

@pytest.mark.cuda
def test_pinned_and_device_round_trip_on_card(card):
    h = tres.device_resources(card)
    p = tmd.make_pinned_matrix(64, 32)
    assert p.data.is_pinned()
    x = torch.randn(64, 32, device=card)
    dst = tmd.make_pinned_matrix(64, 32)
    tmd.copy(h, dst, tmd.MdArray(x, tmt.DEVICE))
    assert dst.data.is_pinned()
    back = tmd.make_device_matrix(h, 64, 32)
    tmd.copy(h, back, dst)
    assert torch.equal(back.data, x)
    assert tser.dumps(x) == tser.dumps(x.cpu())
    assert torch.equal(tser.loads(tser.dumps(x), res=h), x)
    stats = tres.get_memory_stats(h)
    assert stats["bytes_in_use"] == torch.cuda.memory_allocated(card)
    assert stats["bytes_limit"] > 0
