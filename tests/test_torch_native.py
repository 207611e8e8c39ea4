"""The port's native host runtime against the reference package's: the
library builds with g++ from the port's own source into ``build/native``,
its ``.npy`` bytes equal ``core/serialize``'s and the reference's, and
the pool, monitor, thread pool and cancellation registry behave as the
reference's do. Without a toolchain the import still succeeds and the
build error is kept.
"""

import io
import os
import threading
import types

import numpy as np
import pytest
import torch

from raft_tpu_torch import _native
from raft_tpu_torch.core import native_runtime as tnr
from raft_tpu_torch.core import serialize as tser

SEED = 16
DTYPES = [np.float32, np.float64, np.int32, np.int64, np.int16, np.int8,
          np.uint8, np.uint32, np.uint64, np.bool_, np.float16]


@pytest.fixture(scope="module")
def ref():
    from raft_tpu.core import native_runtime, serialize

    return types.SimpleNamespace(nr=native_runtime, ser=serialize)


def _array(dtype, shape=(5, 6)):
    rng = np.random.default_rng(SEED)
    if dtype == np.bool_:
        return rng.uniform(size=shape) < 0.5
    if np.issubdtype(dtype, np.floating):
        return rng.normal(size=shape).astype(dtype)
    return rng.integers(0, 100, size=shape).astype(dtype)


def test_builds_from_the_ports_source_under_build():
    assert tnr.native_available(), _native.build_error()
    assert _native.build_error() == ""
    path = _native.library_path()
    assert path.exists() and path.parent == _native.BUILD_DIR
    assert path.parent.parts[-2:] == ("build", "native")
    assert _native.source_digest() in path.name
    src_dir = os.path.dirname(_native.__file__)
    assert not [f for f in os.listdir(src_dir) if f.endswith(".so")]
    assert _native.get_lib().rt_version() == 1


def test_no_toolchain_keeps_the_error(monkeypatch, tmp_path):
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(_native, "_lib", None)
    monkeypatch.setenv("PATH", str(tmp_path))
    assert not tnr.native_available()
    assert "g++" in _native.build_error()
    with pytest.raises(RuntimeError, match="native runtime unavailable"):
        tnr.TrackedHostPool()
    # the .npy writer falls back to numpy, byte for byte
    a = _array(np.float32)
    p = tmp_path / "a.npy"
    tnr.npy_save(str(p), a)
    assert p.read_bytes() == tser.dumps(a)
    np.testing.assert_array_equal(tnr.npy_load(str(p)), a)
    tnr.native_cancel()
    assert tnr.native_check_cancelled() and not tnr.native_check_cancelled()


@pytest.mark.parametrize("dtype", DTYPES)
def test_npy_bytes_equal_serialize_and_the_reference(ref, tmp_path, dtype):
    a = _array(dtype)
    mine, theirs = tmp_path / "p.npy", tmp_path / "r.npy"
    tnr.npy_save(str(mine), torch.from_numpy(a))
    ref.nr.npy_save(str(theirs), a)
    assert mine.read_bytes() == theirs.read_bytes() == tser.dumps(a) \
        == ref.ser.dumps(a)
    back = tnr.npy_load(str(mine))
    assert back.dtype == a.dtype
    np.testing.assert_array_equal(back, a)
    np.testing.assert_array_equal(ref.nr.npy_load(str(mine)), a)


def test_npy_shapes_and_bf16(ref, tmp_path):
    for shape in ((), (7,), (2, 3, 4), (0, 5)):
        a = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)
        p = tmp_path / "s.npy"
        tnr.npy_save(str(p), a)
        assert p.read_bytes() == tser.dumps(a)
        assert tnr.npy_load(str(p)).shape == shape
    f = np.asfortranarray(np.arange(12, dtype=np.int32).reshape(3, 4))
    buf = io.BytesIO()
    np.save(buf, f)
    p = tmp_path / "f.npy"
    p.write_bytes(buf.getvalue())
    np.testing.assert_array_equal(tnr.npy_load(str(p)), f)
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3).to(torch.bfloat16)
    tnr.npy_save(str(p), t)
    assert p.read_bytes() == tser.dumps(t)


def test_pool_matches_the_reference(ref):
    pools = [tnr.TrackedHostPool(), ref.nr.TrackedHostPool()]
    events = [[], []]
    for pool, ev in zip(pools, events):
        pool.set_notify(lambda a, n, ev=ev: ev.append((a, n)))
        x = pool.allocate((10, 4), np.float64)
        y = pool.allocate((3,), np.int32)
        x[:] = 1.5
        assert float(x.sum()) == 60.0
        with pytest.raises(ValueError):
            pool.release(x[1:])
        pool.release(x)
        assert pool.allocate((0, 3)).size == 0
        pool.set_notify(None)
        del y
        pool.allocate((2,))
    assert pools[0].stats() == pools[1].stats()
    assert events[0] == events[1]
    for pool in pools:
        pool.close()
        pool.close()


def test_mmap_pool_and_monitor(ref, tmp_path):
    pool = tnr.TrackedHostPool(use_mmap=True)
    a = pool.allocate((256,), np.uint8)
    a[:] = 7
    path = tmp_path / "mon.csv"
    mon = tnr.NativeResourceMonitor(pool, str(path), interval_ms=5)
    mon.set_tag("stage-1")
    threading.Event().wait(0.05)
    mon.stop()
    mon.stop()
    rpool = ref.nr.TrackedHostPool()
    rpath = tmp_path / "ref.csv"
    rmon = ref.nr.NativeResourceMonitor(rpool, str(rpath), interval_ms=5)
    threading.Event().wait(0.02)
    rmon.stop()
    lines = path.read_text().splitlines()
    assert lines[0] == rpath.read_text().splitlines()[0]
    assert any(",stage-1,256,256,1,0" in row for row in lines[1:])
    pool.release(a)
    pool.close()
    rpool.close()
    with pytest.raises(RuntimeError):
        tnr.NativeResourceMonitor(tnr.TrackedHostPool(),
                                  str(tmp_path / "no" / "such.csv"))


def test_parallel_copy(ref):
    rng = np.random.default_rng(SEED)
    src = rng.random((1000, 33), dtype=np.float32)
    tp = tnr.NativeThreadPool(3)
    dst = np.empty_like(src)
    tp.parallel_copy(dst, src, chunk_bytes=4096)
    np.testing.assert_array_equal(dst, src)
    dst2 = np.empty_like(src)
    tp.parallel_copy(dst2, np.asfortranarray(src))
    np.testing.assert_array_equal(dst2, src)
    with pytest.raises(ValueError):
        tp.parallel_copy(np.empty((10,), np.float32), src)
    with pytest.raises(ValueError):
        tp.parallel_copy(np.empty((66, 1000), np.float32).T, src)
    tp.close()
    tp.close()


def test_cancel_registry_matches(ref):
    tid = 10 ** 12 + 16
    for mod in (tnr, ref.nr):
        assert not mod.native_check_cancelled(tid)
        mod.native_cancel(tid)
        assert mod.native_check_cancelled(tid)
        assert not mod.native_check_cancelled(tid)
    got = []
    t = threading.Thread(target=lambda: (tnr.native_cancel(),
                                         got.append(
                                             tnr.native_check_cancelled())))
    t.start()
    t.join(30)
    assert not t.is_alive() and got == [True]
    assert not tnr.native_check_cancelled()
