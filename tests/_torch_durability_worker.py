"""Worker and orchestrator of the port's two-process WAL-shipping
witnesses (tests/test_torch_durability.py); imports torch and the port
only, and runs on the CPU.

Each process binds its own TCP listener (port 0) and reports the address
it bound under the rendezvous directory, so no port is picked by one
process and bound by another. A restarted process binds its earlier
port again (retrying while the kernel still holds it).

Roles (``python tests/_torch_durability_worker.py <role> ...``):

``leader --dir D --rdv R``
    Rank 0: builds the journaled index, attaches a
    :class:`~raft_tpu_torch.neighbors.wal_ship.WalShipper`, waits for the
    follower's READY, runs the fixed mutation sequence (a forced refit
    in the middle, so a KIND_CENTROIDS record crosses the wire), then
    serves catch-up until the follower's DONE. Prints ``LEADER_OK
    crc=<c> seq=<s> ship_errors=<n>``.

``follower --dir D --rdv R [--kill-at-seq N]``
    Rank 1: bootstraps a blank follower (snapshot resync) and drains live
    records. With ``--kill-at-seq`` it SIGKILLs itself once its cursor
    reaches N (no atexit, no finally); without, it drains to the target,
    sends DONE and prints ``FOLLOWER_OK crc=<c> applied=<s>``.

``follower --dir D --rdv R --resume``
    Rank 1 restarted: recovers the index from its mirrored journal,
    catches up to the target under query load
    (:func:`~raft_tpu_torch.serve.loadgen.catchup_under_load`), sends DONE
    and prints ``FOLLOWER_OK crc=<c> applied=<s> resumed=<r>
    min_recall=<f> queries=<q> resyncs=<n>``.

``clean --dir D``
    The twin that is never killed: the same sequence in one process, no
    comms. Prints ``CLEAN_OK crc=<c> seq=<s>``.

``orchestrate [--kill]``
    Runs the clean twin, the leader and the follower (with ``--kill``:
    killed at KILL_AT_SEQ, rc -9 asserted, then resumed) as processes
    and asserts the three CRCs equal (and, with ``--kill``, the cursor
    kept across the kill and the recall floor held). Prints
    ``DURABILITY_CHAOS_OK ...``. Every wait is bounded (WAIT_S a
    process).
"""

import argparse
import errno
import os
import signal
import subprocess
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

N_DB, DIM, N_LISTS = 160, 8, 8
N_BATCHES = 8           # each batch: one insert and one delete record
B_ROWS = 12
REFIT_AT = 4            # a forced refit after this batch (one record)
TARGET_SEQ = 2 * N_BATCHES          # 17 records, seqs 0..16
KILL_AT_SEQ = 6                      # mid-stream, before the refit
K, NPROBE = 5, N_LISTS               # exact probe: the recall floor is 1
TAG_READY, TAG_DONE = 7400, 7401
WAIT_S = 100.0


def _res():
    from raft_tpu_torch import device_resources

    return device_resources("cpu")


def bind_box(rank, n, rdv, *, port=0):
    """A TcpMailbox for ``rank`` bound to ``port`` (0: any free port),
    its address published as ``rdv/rank-<r>``, and every peer's address
    read back from there once all ``n`` are published."""
    from raft_tpu_torch.comms.tcp_mailbox import TcpMailbox

    addrs = ["127.0.0.1:0"] * n
    addrs[rank] = f"127.0.0.1:{port}"
    deadline = time.monotonic() + 20.0
    while True:
        try:
            box = TcpMailbox(rank, addrs, heartbeat_interval=0.3,
                             heartbeat_timeout=2.0)
            break
        except OSError as exc:
            # a restart rebinding its port while the kernel still holds
            # it: wait for the release
            if exc.errno != errno.EADDRINUSE or \
                    time.monotonic() > deadline:
                raise
            time.sleep(0.2)
    me = f"127.0.0.1:{box._srv.getsockname()[1]}"
    path = os.path.join(rdv, f"rank-{rank}")
    with open(path + ".tmp", "w") as f:
        f.write(me)
    os.replace(path + ".tmp", path)
    out = [None] * n
    deadline = time.monotonic() + WAIT_S
    while None in out:
        for r in range(n):
            p = os.path.join(rdv, f"rank-{r}")
            if out[r] is None and os.path.exists(p):
                out[r] = open(p).read().strip()
        if None in out:
            assert time.monotonic() < deadline, f"rendezvous: {out}"
            time.sleep(0.05)
    box.addrs = out
    return box


def published_port(rdv, rank):
    return int(open(os.path.join(rdv, f"rank-{rank}")).read()
               .rsplit(":", 1)[1])


def _mutate(idx, rng):
    """The fixed mutation sequence both twins run; yields after each
    batch so the leader can pace live shipping."""
    for i in range(N_BATCHES):
        ids = idx.insert(rng.normal(size=(B_ROWS, DIM)).astype("float32"))
        idx.delete(ids[::3])
        if i == REFIT_AT:
            idx.maybe_refit(force=True)
        yield i


def _build(directory):
    import numpy as np

    from raft_tpu_torch.neighbors import streaming

    rng = np.random.default_rng(7)
    db = rng.normal(size=(N_DB, DIM)).astype(np.float32)
    idx = streaming.stream_build(_res(), db, N_LISTS, seed=0, max_iter=4,
                                 directory=directory)
    return idx, rng


def run_clean(directory):
    idx, rng = _build(directory)
    for _ in _mutate(idx, rng):
        pass
    print(f"CLEAN_OK crc={idx.content_crc()} seq={idx._applied_seq}",
          flush=True)


def run_leader(directory, rdv):
    import numpy as np

    from raft_tpu_torch.comms.errors import CommsTimeoutError, PeerFailedError
    from raft_tpu_torch.neighbors.wal_ship import WalShipper

    box = bind_box(0, 2, rdv)
    idx, rng = _build(directory)
    shipper = WalShipper(idx, box, 0, [1], poll_interval=0.01)
    shipper.attach()
    shipper.start()
    np.asarray(box.get(1, 0, TAG_READY, timeout=WAIT_S))
    for _ in _mutate(idx, rng):
        time.sleep(0.03)        # pace: a kill lands mid-stream
    print(f"LEADER_STREAMED seq={idx._applied_seq}", flush=True)
    # wait for the follower's DONE; a killed follower marks the peer
    # failed (gets fail fast), so revive and retry until it is back
    deadline = time.monotonic() + WAIT_S
    while True:
        try:
            np.asarray(box.get(1, 0, TAG_DONE, timeout=5.0))
            break
        except (PeerFailedError, CommsTimeoutError):
            if time.monotonic() > deadline:
                raise
            box.revive_peer(1)
    print(f"LEADER_OK crc={idx.content_crc()} seq={idx._applied_seq} "
          f"ship_errors={shipper.ship_errors}", flush=True)
    shipper.stop()
    shipper.detach()
    box.close()


def run_follower(directory, rdv, kill_at_seq):
    import numpy as np

    from raft_tpu_torch.neighbors.wal_ship import (WalFollower,
                                                   bootstrap_follower)

    box = bind_box(1, 2, rdv)
    idx = bootstrap_follower(_res(), dim=DIM, n_lists=N_LISTS,
                             directory=directory)
    wf = WalFollower(idx, box, 1, 0)
    box.put(1, 0, TAG_READY, np.asarray([1], np.int64))
    wf.catch_up(timeout=WAIT_S)     # cursor -1: snapshot resync
    stop_at = TARGET_SEQ if kill_at_seq is None else kill_at_seq
    deadline = time.monotonic() + WAIT_S
    while wf.applied_seq < stop_at:
        assert time.monotonic() < deadline, wf.applied_seq
        if wf.drain() == 0:
            time.sleep(0.005)
    if kill_at_seq is not None:
        print(f"FOLLOWER_SUICIDE seq={wf.applied_seq}", flush=True)
        sys.stdout.flush()
        os.kill(os.getpid(), signal.SIGKILL)
    box.put(1, 0, TAG_DONE, np.asarray([1], np.int64))
    print(f"FOLLOWER_OK crc={idx.content_crc()} applied={wf.applied_seq}",
          flush=True)
    time.sleep(0.2)                 # let the DONE frame flush
    box.close()


def run_follower_resume(directory, rdv):
    import numpy as np

    from raft_tpu_torch.neighbors.streaming import StreamingIndex
    from raft_tpu_torch.neighbors.wal_ship import WalFollower
    from raft_tpu_torch.serve.loadgen import catchup_under_load

    box = bind_box(1, 2, rdv, port=published_port(rdv, 1))
    # the killed replica's restart: its epoch and mirrored WAL give the
    # state and the cursor it had
    idx = StreamingIndex.recover(_res(), directory)
    resumed = idx._applied_seq
    print(f"FOLLOWER_RESUMED seq={resumed}", flush=True)
    wf = WalFollower(idx, box, 1, 0)
    rep = catchup_under_load(wf, k=K, nprobe=NPROBE,
                             target_seq=TARGET_SEQ, rows=4, seed=3,
                             wait_s=60.0)
    box.put(1, 0, TAG_DONE, np.asarray([1], np.int64))
    print(f"FOLLOWER_OK crc={idx.content_crc()} "
          f"applied={wf.applied_seq} resumed={resumed} "
          f"min_recall={rep.min_recall:.4f} queries={rep.queries} "
          f"resyncs={rep.resyncs}", flush=True)
    time.sleep(0.2)
    box.close()


# -- orchestrator ------------------------------------------------------


def _field(out, marker, key):
    import re

    m = re.search(rf"{marker}\b.*\b{key}=([\d.+-]+)", out)
    assert m, f"missing {marker} {key}= in:\n{out}"
    return m.group(1)


def orchestrate(kill):
    import tempfile

    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    me = os.path.abspath(__file__)

    def launch(args):
        return subprocess.Popen([sys.executable, me] + args, cwd=_REPO,
                                env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)

    with tempfile.TemporaryDirectory() as tmp:
        rdv = os.path.join(tmp, "rdv")
        os.makedirs(rdv)
        d_clean = os.path.join(tmp, "clean")
        d_lead = os.path.join(tmp, "leader")
        d_foll = os.path.join(tmp, "follower")
        procs = []
        try:
            clean = launch(["clean", "--dir", d_clean])
            leader = launch(["leader", "--dir", d_lead, "--rdv", rdv])
            procs += [clean, leader]
            extra = ["--kill-at-seq", str(KILL_AT_SEQ)] if kill else []
            f1 = launch(["follower", "--dir", d_foll, "--rdv", rdv]
                        + extra)
            procs.append(f1)
            out1 = f1.communicate(timeout=WAIT_S + 20)[0]
            if kill:
                assert f1.returncode == -9, \
                    f"follower was not SIGKILLed (rc={f1.returncode}):" \
                    f"\n{out1}"
                assert "FOLLOWER_SUICIDE" in out1, out1
                f2 = launch(["follower", "--dir", d_foll, "--rdv", rdv,
                             "--resume"])
                procs.append(f2)
                out2 = f2.communicate(timeout=WAIT_S + 20)[0]
                assert f2.returncode == 0, f"resumed follower:\n{out2}"
            else:
                assert f1.returncode == 0, f"follower failed:\n{out1}"
                out2 = out1
            out_l = leader.communicate(timeout=WAIT_S + 20)[0]
            assert leader.returncode == 0, f"leader failed:\n{out_l}"
            out_c = clean.communicate(timeout=WAIT_S + 20)[0]
            assert clean.returncode == 0, f"clean twin failed:\n{out_c}"
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()

    crc_clean = _field(out_c, "CLEAN_OK", "crc")
    crc_lead = _field(out_l, "LEADER_OK", "crc")
    crc_foll = _field(out2, "FOLLOWER_OK", "crc")
    assert crc_lead == crc_clean, \
        f"leader diverged from the clean twin: {crc_lead} != {crc_clean}"
    assert crc_foll == crc_lead, \
        f"follower diverged: {crc_foll} != {crc_lead}"
    applied = int(_field(out2, "FOLLOWER_OK", "applied"))
    assert applied >= TARGET_SEQ, out2
    line = f"DURABILITY_CHAOS_OK crc={crc_foll} applied={applied}"
    if kill:
        # the cursor survived the kill: the restart resumed at least at
        # the kill threshold (a drain may overshoot by one queued batch)
        # and short of the leader's horizon
        resumed = int(_field(out2, "FOLLOWER_OK", "resumed"))
        assert KILL_AT_SEQ <= resumed < TARGET_SEQ, out2
        min_recall = float(_field(out2, "FOLLOWER_OK", "min_recall"))
        queries = int(_field(out2, "FOLLOWER_OK", "queries"))
        assert queries >= 1, out2
        assert min_recall >= 0.99, \
            f"recall floor broken during catch-up: {min_recall}\n{out2}"
        line += (f" resumed={resumed} min_recall={min_recall:.4f} "
                 f"queries={queries}")
    print(line, flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("role", choices=["leader", "follower", "clean",
                                    "orchestrate"])
    p.add_argument("--dir")
    p.add_argument("--rdv")
    p.add_argument("--kill-at-seq", type=int, default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--kill", action="store_true")
    a = p.parse_args(argv)
    if a.role == "orchestrate":
        orchestrate(a.kill)
    elif a.role == "clean":
        run_clean(a.dir)
    elif a.role == "leader":
        run_leader(a.dir, a.rdv)
    elif a.resume:
        run_follower_resume(a.dir, a.rdv)
    else:
        run_follower(a.dir, a.rdv, a.kill_at_seq)
    return 0


if __name__ == "__main__":
    sys.exit(main())
