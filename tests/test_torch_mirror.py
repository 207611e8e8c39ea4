"""Rule 1 of the port (ROADMAP.md): each module of ``raft_tpu_torch`` that
has a counterpart in ``raft_tpu`` carries the reference's public names,
with the reference's parameters in the reference's order.

Read with ``inspect`` on both packages. A module's public names are the
functions and classes it defines (not those it imports) whose names do
not start with an underscore; a class's are its public methods and
properties. For each, the reference's parameter names must appear in the
port's signature in the same order (the port may add parameters after
them, as the CUDA routes' keyword-only knobs). A property of the
reference may be a plain instance attribute in the port.

:data:`GAPS` lists the names still allowed to be missing or different,
each with the ROADMAP queue item that brings it. A gap that closes must
leave the list, and a new gap fails the test.
"""

import importlib
import inspect
import pkgutil
import re

import pytest

import raft_tpu_torch

# (reference module, name): the queue item that ports it
GAPS = {
    # A11: the slot grid's TPU layout, which closes with the simplicity
    # follow-up that drops prepare()'s layout knobs
    ("raft_tpu.sparse.grid_spmv", "GridSpMV"): "A11",
    ("raft_tpu.sparse.grid_spmv", "prepare"): "A11",
    ("raft_tpu.sparse.solver.mst_grid", "MSTGridPlan"): "A11",
    # A13b: the guard modes (the reference's runtime.aot has no port
    # module yet, so the walk does not reach its names)
    ("raft_tpu.core.guards", "ArtifactCorruptError"): "A13b",
    ("raft_tpu.core.guards", "guard_mode"): "A13b",
    ("raft_tpu.core.guards", "set_guard_mode"): "A13b",
    ("raft_tpu.core.guards", "guard_scope"): "A13b",
    ("raft_tpu.core.guards", "finite_sentinel"): "A13b",
    ("raft_tpu.core.guards", "check_finite"): "A13b",
    ("raft_tpu.core.guards", "guard_output"): "A13b",
    # A17: the reference's TPU tile knobs (tm, tn, packed, counts_mxu)
    # and its Pallas-ref helper signatures
    ("raft_tpu.cluster.kmeans", "lloyd_step_prepared"): "A17",
    ("raft_tpu.cluster.kmeans", "lloyd_iterate_prepared"): "A17",
    ("raft_tpu.linalg.contractions", "pairwise_pallas"): "A17",
    ("raft_tpu.linalg.contractions", "pairwise_l2_pallas"): "A17",
    ("raft_tpu.linalg.contractions", "fused_argmin_pallas"): "A17",
    ("raft_tpu.linalg.contractions", "fused_l2_argmin_pallas"): "A17",
    ("raft_tpu.linalg.contractions", "lloyd_prepare"): "A17",
    ("raft_tpu.linalg.contractions", "fused_lloyd_prepared"): "A17",
    ("raft_tpu.linalg.contractions", "fused_lloyd_pallas"): "A17",
    ("raft_tpu.matrix.epilogue", "masked_fold"): "A17",
    ("raft_tpu.matrix.epilogue", "insert_drain"): "A17",
}


def _pairs():
    out = []
    for info in pkgutil.walk_packages(raft_tpu_torch.__path__,
                                      "raft_tpu_torch."):
        ref = "raft_tpu" + info.name[len("raft_tpu_torch"):]
        try:
            found = importlib.util.find_spec(ref) is not None
        except ModuleNotFoundError:
            found = False
        if found:
            out.append((info.name, ref))
    return out


PAIRS = _pairs()


def _public(mod):
    return {name: obj for name, obj in vars(mod).items()
            if not name.startswith("_")
            and (inspect.isfunction(obj) or inspect.isclass(obj))
            and getattr(obj, "__module__", None) == mod.__name__}


def _params(obj):
    target = obj.__init__ if inspect.isclass(obj) else obj
    try:
        sig = inspect.signature(target)
    except (TypeError, ValueError):
        return None
    return [p for p in sig.parameters if p not in ("self", "cls")]


def _in_order(want, have) -> bool:
    """``want`` is a subsequence of ``have``."""
    it = iter(have)
    return all(name in it for name in want)


def _gaps(port_name: str, ref_name: str):
    port = importlib.import_module(port_name)
    ref = importlib.import_module(ref_name)
    found = []
    for name, robj in _public(ref).items():
        if name not in vars(port):
            found.append((name, "missing"))
            continue
        pobj = getattr(port, name)
        rp, tp = _params(robj), _params(pobj)
        if rp is not None and tp is not None and not _in_order(rp, tp):
            found.append((name, f"parameters {rp} not in order in {tp}"))
        if not (inspect.isclass(robj) and inspect.isclass(pobj)):
            continue
        init_src = inspect.getsource(pobj)
        for mname, member in vars(robj).items():
            if mname.startswith("_"):
                continue
            if isinstance(member, property):
                if not (hasattr(pobj, mname)
                        or re.search(rf"self\.{mname}\s*=", init_src)):
                    found.append((f"{name}.{mname}", "missing"))
                continue
            if not inspect.isfunction(member):
                continue
            if not hasattr(pobj, mname):
                found.append((f"{name}.{mname}", "missing"))
                continue
            rp = _params(member)
            tp = _params(getattr(pobj, mname))
            if rp is not None and tp is not None and not _in_order(rp, tp):
                found.append((f"{name}.{mname}",
                              f"parameters {rp} not in order in {tp}"))
    return found


@pytest.mark.parametrize("port_name,ref_name", PAIRS,
                         ids=[p for p, _ in PAIRS])
def test_public_names_and_parameters_mirror_the_reference(port_name,
                                                          ref_name):
    unlisted = [(name, why) for name, why in _gaps(port_name, ref_name)
                if (ref_name, name) not in GAPS]
    assert not unlisted, f"{ref_name}: new gaps {unlisted}"


def test_every_listed_gap_is_still_open():
    """A gap that closes leaves GAPS, so the list stays the queue's."""
    open_now = {(ref, name) for port, ref in PAIRS
                for name, _ in _gaps(port, ref)}
    closed = sorted(set(GAPS) - open_now)
    assert not closed, f"closed gaps still listed: {closed}"


def test_comms_exports_the_reference_names_but_the_tcp_transport():
    """Every public name of the reference's comms package, the TCP
    transport ``TcpMailbox`` included (the test keeps its name from when
    the transport was not ported yet)."""
    import raft_tpu.comms as rc
    import raft_tpu_torch.comms as tcm

    want = {n for n in vars(rc) if not n.startswith("_")
            and not inspect.ismodule(getattr(rc, n))}
    assert "TcpMailbox" in want
    have = {n for n in vars(tcm) if not n.startswith("_")}
    assert want <= have, sorted(want - have)


def test_guard_mode_resolves_as_the_reference():
    import numpy as np
    import torch

    from raft_tpu.core.guards import resolve_guard_mode as r_resolve
    from raft_tpu_torch.core.guards import resolve_guard_mode
    from raft_tpu_torch.distance import pairwise_distance

    assert resolve_guard_mode() == r_resolve() == "off"
    assert resolve_guard_mode("OFF") == "off"
    x = torch.as_tensor(np.ones((3, 2), np.float32))
    for bogus in ("bogus", "chek"):
        with pytest.raises(ValueError):
            r_resolve(bogus)
        with pytest.raises(ValueError):
            resolve_guard_mode(bogus)
        with pytest.raises(ValueError):
            pairwise_distance(None, x, x, guard_mode=bogus)
    for mode in ("check", "recover"):
        with pytest.raises(NotImplementedError, match="item 13"):
            resolve_guard_mode(mode)


def test_env_registry_mirrors_the_reference():
    from raft_tpu.core import env as r_env
    from raft_tpu_torch.core import env

    assert env.parse_bytes("2g") == r_env.parse_bytes("2g") == 2 << 30
    assert env.parse_bytes("512m") == r_env.parse_bytes("512m")
    for bad in ("", "12q", "-1", "0"):
        with pytest.raises(ValueError):
            env.parse_bytes(bad)
    assert set(env.registry()) <= set(r_env.registry())
    for name, spec in env.registry().items():
        assert spec.on_malformed == r_env.registry()[name].on_malformed \
            or name in ("RAFT_TPU_MATMUL_PRECISION", "RAFT_TPU_SPARSE_PAD")
    with pytest.raises(ValueError):
        env.register("NOT_A_KNOB", str)
    with pytest.raises(ValueError):
        env.register("RAFT_TPU_X", str, on_malformed="ignore")
