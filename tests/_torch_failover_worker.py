"""Worker and orchestrator of the port's three-process leader-failover
witness (tests/test_torch_failover.py); imports torch and the port only,
and runs on the CPU.

SIGKILL the leader of a 3-node TCP fleet mid-stream in quorum-ack mode:
the survivors elect the most caught-up follower, writes resume through
the promoted controller, every client-acked sequence is on the new
leader with ``content_crc`` equal to a twin's replay of the same durable
prefix, and the old leader rejoins, truncates its unreplicated suffix
behind a typed :class:`TermFencedError` and converges.

Each process binds its own listener and publishes its address under the
rendezvous directory (``_torch_durability_worker.bind_box``); the
restarted leader binds its earlier port again.

Roles (``python tests/_torch_failover_worker.py <role> ...``):

``leader --dir D --rdv R``
    Rank 0: builds the journaled index, runs an
    :class:`~raft_tpu_torch.neighbors.election.ElectionNode` as leader
    with ``acks="majority"``, waits for both followers' READY, then runs
    the fixed op sequence (each op returns once quorum-acked and prints
    ``ACKED seq=<s>``) and SIGKILLs itself after ``KILL_AT_ACKS`` acked
    ops (``LEADER_SUICIDE wall=<t>``).

``follower --dir D --rdv R --rank R``
    Ranks 1 and 2: bootstrap over the wire (snapshot resync), then serve
    through a :class:`StreamingKnnService` and an
    :class:`IngestController` wired to an election node. After the
    leader dies, one follower prints ``PROMOTED rank=<r> ...
    ballot_applied=<a> crc=<c> traces_pre=<n> traces_post=<n>`` (the CRC
    taken before any resumed write: the durable prefix the clean twin
    must match); the other prints ``REDIRECT leader=<r>`` (the typed
    NotLeaderError) and ``LOSER_OK crc=<c>``. The winner then takes
    quorum-acked writes, shepherds the old leader's rejoin (HELLO/GO)
    and prints ``WINNER_FINAL crc=<c>``.

``rejoin --dir D --rdv R``
    Rank 0 restarted: recovers the killed leader's journal, appends a
    term-0 suffix nobody saw, waits for the new leader's GO, then starts
    a node that still believes it leads, which is fenced, truncates,
    demotes and heals. Prints ``REJOIN_OK fenced=TermFencedError
    divergence=<s> truncated=<n> crc=<c>``.

``clean --dir D --records N``
    The twin: replays the first N ops of the sequence in one process.
    Prints ``CLEAN_OK crc=<c>``.

``orchestrate``
    Runs it all as processes and asserts: the leader's rc is -9; the
    election lands within 2x the transport's heartbeat timeout; the
    winner carried the highest ballot; every acked seq is inside the
    winner's ballot prefix (no acked write lost); the promotion CRC is
    the clean twin's; no trace after the promotion on the serving path;
    the loser's redirect names the winner; the three final CRCs agree;
    the rejoiner's divergence is ``ballot_applied + 1`` with a non-empty
    truncation. Prints ``FAILOVER_CHAOS_OK ...``. Every wait is bounded
    (WAIT_S a process).
"""

import argparse
import os
import signal
import subprocess
import sys
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(_HERE)
sys.path.insert(0, _REPO)
sys.path.insert(0, _HERE)

from _torch_durability_worker import bind_box, published_port  # noqa: E402

N_DB, DIM, N_LISTS = 160, 8, 8
B_ROWS = 6
KILL_AT_ACKS = 12       # acked ops before the leader kills itself
RESUME_OPS = 3          # quorum-acked writes after the promotion
K, NPROBE = 5, 4
HB_TIMEOUT = 2.0        # the transport's failure detector (bind_box)
ELECTION_TIMEOUT = 1.0  # the application's silence threshold
TAG_READY, TAG_DONE = 7400, 7401
TAG_FINAL, TAG_HELLO, TAG_GO = 7402, 7403, 7404
WAIT_S = 110.0


def _res():
    from raft_tpu_torch import device_resources

    return device_resources("cpu")


def _op_stream():
    """The fixed op sequence both twins run. Each op is one WAL record,
    so a replay of the first N ops gives the content of any N-record
    durable prefix bit for bit."""
    import itertools

    import numpy as np

    rng = np.random.default_rng(7)
    next_id = N_DB
    for n in itertools.count():
        if n % 4 == 3:
            prev = list(range(next_id - B_ROWS, next_id))
            yield n, ("delete", np.asarray(prev[::3], np.int64))
        else:
            yield n, ("insert",
                      rng.normal(size=(B_ROWS, DIM)).astype(np.float32))
            next_id += B_ROWS


def _apply_op(idx, n, op):
    kind, payload = op
    if kind == "insert":
        idx.insert(payload, write_id=n)
    else:
        idx.delete(payload)


def _build(directory):
    import numpy as np

    from raft_tpu_torch.neighbors import streaming

    rng = np.random.default_rng(7)
    db = rng.normal(size=(N_DB, DIM)).astype(np.float32)
    idx = streaming.stream_build(_res(), db, N_LISTS, seed=0, max_iter=4,
                                 directory=directory, repack_slack=64)
    # tail slack up front: the op stream then fits without a repack
    # that changes shapes, so the promotion's snapshot roll changes
    # content only and the no-recompile witness is strict
    idx.compact(reason="provision")
    return idx


def _node_kw():
    return dict(acks="majority", ack_timeout=30.0,
                heartbeat_interval=0.25,
                election_timeout=ELECTION_TIMEOUT, poll_interval=0.02)


def run_clean(directory, records):
    idx = _build(directory)
    for n, op in _op_stream():
        if n >= records:
            break
        _apply_op(idx, n, op)
    print(f"CLEAN_OK crc={idx.content_crc()} applied={idx.applied_seq}",
          flush=True)


def run_leader(directory, rdv):
    import numpy as np

    from raft_tpu_torch.neighbors.election import ElectionNode

    box = bind_box(0, 3, rdv)
    idx = _build(directory)
    node = ElectionNode(idx, box, 0, [0, 1, 2], role="leader", leader=0,
                        **_node_kw())
    node.start()
    for r in (1, 2):
        np.asarray(box.get(r, 0, TAG_READY, timeout=WAIT_S))
    for n, op in _op_stream():
        if n >= KILL_AT_ACKS:
            break
        _apply_op(idx, n, op)       # returns once quorum-acked
        print(f"ACKED seq={idx.applied_seq} op={n}", flush=True)
        time.sleep(0.02)
    print(f"LEADER_SUICIDE wall={time.time():.6f} seq={idx.applied_seq}",
          flush=True)
    sys.stdout.flush()
    os.kill(os.getpid(), signal.SIGKILL)


def run_follower(directory, rdv, rank):
    import numpy as np

    from raft_tpu_torch import serve
    from raft_tpu_torch.comms.errors import CommsTimeoutError, PeerFailedError
    from raft_tpu_torch.neighbors.election import ElectionNode
    from raft_tpu_torch.neighbors.wal_ship import (WalFollower,
                                                   bootstrap_follower)
    from raft_tpu_torch.serve.ingest import NotLeaderError

    box = bind_box(rank, 3, rdv)
    idx = bootstrap_follower(_res(), dim=DIM, n_lists=N_LISTS,
                             directory=directory)
    wf = WalFollower(idx, box, rank, 0)
    wf.catch_up(timeout=WAIT_S)     # snapshot resync: the base build
    svc = serve.StreamingKnnService(idx, k=K, nprobe=NPROBE)
    node = ElectionNode(idx, box, rank, [0, 1, 2], role="follower",
                        leader=0, follower=wf, **_node_kw())
    ctl = serve.IngestController(
        idx, [svc], policy=serve.BatchPolicy(max_batch=8, max_wait_ms=2.0),
        compact_interval=30.0, refit=False, warm_buckets=[4],
        election=node)
    ctl.start()
    q = np.random.default_rng(40 + rank).normal(
        size=(4, DIM)).astype(np.float32)
    ctl.submit(svc.name, q).result(timeout=WAIT_S)  # the first touch
    box.put(rank, 0, TAG_READY, np.asarray([rank], np.int64))

    deadline = time.monotonic() + WAIT_S
    while True:
        assert time.monotonic() < deadline, (node.role, node._error)
        if node._error is not None:
            raise node._error
        if node.role == "leader" and node.last_election is not None:
            won = True
            break
        # the role flips before last_election lands on the winner: only
        # a settled follower pointing away from rank 0 is the loser
        if node.role == "follower" and node.leader != 0:
            won = False
            break
        time.sleep(0.02)

    if won:
        # last_election is set after _promote returns, so the promotion
        # hook (and any re-warm it paid) is done: from here the serving
        # path compiles nothing
        rec = node.last_election
        t_pre = ctl.executor.stats.traces
        ctl.submit(svc.name, q).result(timeout=WAIT_S)
        t_post = ctl.executor.stats.traces
        ballot_applied = rec.votes[rec.winner][1]
        votes_s = ";".join(f"{r}:{a}" for r, (_t, a)
                           in sorted(rec.votes.items()))
        print(f"PROMOTED rank={rank} wall={time.time():.6f} "
              f"term={idx.term} ballot_applied={ballot_applied} "
              f"applied={idx.applied_seq} crc={idx.content_crc()} "
              f"votes={votes_s} seconds={rec.seconds:.3f} "
              f"traces_pre={t_pre} traces_post={t_post}", flush=True)
        rng2 = np.random.default_rng(100)
        loser = 3 - rank
        try:
            for j in range(RESUME_OPS):     # quorum-acked by the loser
                ctl.insert(rng2.normal(size=(4, DIM)).astype(np.float32),
                           write_id=1000 + j)
        except Exception:
            sh = node.shipper
            print(f"WINNER_STUCK followers={sh.followers} "
                  f"shipped={sh.shipped} acked={sh.acked_seq(loser)} "
                  f"applied={idx.applied_seq}", flush=True)
            raise
        final_applied = idx.applied_seq
        box.put(rank, loser, TAG_FINAL,
                np.asarray([final_applied], np.int64))
        # shepherd the old leader's rejoin: wait for its HELLO (its
        # frames revive it in this mailbox), then GO (with the
        # convergence target) once these writes are in
        while True:
            assert time.monotonic() < deadline, "no HELLO from rank 0"
            if box.get_nowait(0, rank, TAG_HELLO) is not None:
                break
            time.sleep(0.1)
        box.put(rank, 0, TAG_GO, np.asarray([final_applied], np.int64))
        while True:
            try:
                np.asarray(box.get(0, rank, TAG_DONE, timeout=5.0))
                break
            except (PeerFailedError, CommsTimeoutError):
                assert time.monotonic() < deadline, "no DONE from rank 0"
                box.revive_peer(0)
        box.put(rank, loser, TAG_DONE, np.asarray([1], np.int64))
        print(f"WINNER_FINAL crc={idx.content_crc()} "
              f"applied={idx.applied_seq}", flush=True)
        time.sleep(0.2)             # let the last frame flush
    else:
        # the typed redirect: a write on a follower names the leader
        try:
            ctl.insert(np.zeros((2, DIM), np.float32), write_id=9999)
            print("REDIRECT_FAIL no NotLeaderError", flush=True)
        except NotLeaderError as exc:
            print(f"REDIRECT leader={exc.leader}", flush=True)
        winner = node.leader
        fin = None
        while fin is None:
            assert time.monotonic() < deadline, "no FINAL from winner"
            fin = box.get_nowait(winner, rank, TAG_FINAL)
            time.sleep(0.02)
        target = int(np.asarray(fin)[0])
        while idx.applied_seq < target:
            assert time.monotonic() < deadline, \
                (idx.applied_seq, target, node._error)
            time.sleep(0.02)
        time.sleep(0.5)             # let the last apply's swap settle
        print(f"LOSER_OK rank={rank} crc={idx.content_crc()} "
              f"applied={idx.applied_seq}", flush=True)
        # stay up through the old leader's rejoin: an early exit would
        # leave its HELLOs waiting on a dead peer
        np.asarray(box.get(winner, rank, TAG_DONE, timeout=WAIT_S))
    ctl.stop()
    box.close()


def run_rejoin(directory, rdv):
    import numpy as np

    from raft_tpu_torch.neighbors.election import ElectionNode
    from raft_tpu_torch.neighbors.streaming import StreamingIndex

    box = bind_box(0, 3, rdv, port=published_port(rdv, 0))
    idx = StreamingIndex.recover(_res(), directory)
    resumed = idx.applied_seq
    # the cut-off leader's writes: a term-0 suffix the fleet never saw
    rng = np.random.default_rng(55)
    idx.insert(rng.normal(size=(5, DIM)).astype(np.float32))
    stale_applied = idx.applied_seq
    print(f"REJOIN_RECOVERED resumed={resumed} "
          f"stale_applied={stale_applied} term={idx.term}", flush=True)
    hello = np.asarray([0], np.int64)
    winner = target = None
    deadline = time.monotonic() + WAIT_S
    while target is None:
        assert time.monotonic() < deadline, "no GO from the new leader"
        for p in (1, 2):
            try:
                box.put(0, p, TAG_HELLO, hello)
            except Exception:       # noqa: BLE001 — the peer may be gone
                pass
            got = box.get_nowait(p, 0, TAG_GO)
            if got is not None:
                winner, target = p, int(np.asarray(got)[0])
                break
        time.sleep(0.1)
    # a node that still believes it leads at term 0: the fleet fences
    # it, it truncates the suffix, demotes and heals
    node = ElectionNode(idx, box, 0, [0, 1, 2], role="leader", leader=0,
                        **_node_kw())
    node.start()
    while not (node.role == "follower" and node.last_fence is not None):
        assert time.monotonic() < deadline, (node.role, node._error)
        if node._error is not None:
            raise node._error
        time.sleep(0.02)
    while idx.applied_seq < target:
        assert time.monotonic() < deadline, \
            (idx.applied_seq, target, node._error)
        time.sleep(0.02)
    time.sleep(0.5)
    fence = node.last_fence
    truncated = stale_applied - fence.divergence + 1
    print(f"REJOIN_OK fenced={type(fence).__name__} "
          f"divergence={fence.divergence} truncated={truncated} "
          f"term={idx.term} crc={idx.content_crc()} "
          f"applied={idx.applied_seq}", flush=True)
    box.put(0, winner, TAG_DONE, np.asarray([1], np.int64))
    time.sleep(0.2)
    node.stop()
    box.close()


# -- orchestrator ------------------------------------------------------


def _field(out, marker, key):
    import re

    m = re.search(rf"{marker}\b.*\b{key}=([\w.:;+-]+)", out)
    assert m, f"missing {marker} {key}= in:\n{out}"
    return m.group(1)


def orchestrate():
    import re
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
        d_lead = os.path.join(tmp, "leader")
        d_f1 = os.path.join(tmp, "f1")
        d_f2 = os.path.join(tmp, "f2")
        d_clean = os.path.join(tmp, "clean")
        procs = []
        try:
            leader = launch(["leader", "--dir", d_lead, "--rdv", rdv])
            f1 = launch(["follower", "--dir", d_f1, "--rank", "1",
                         "--rdv", rdv])
            f2 = launch(["follower", "--dir", d_f2, "--rank", "2",
                         "--rdv", rdv])
            procs += [leader, f1, f2]
            out0 = leader.communicate(timeout=WAIT_S + 20)[0]
            assert leader.returncode == -9, \
                f"leader was not SIGKILLed (rc={leader.returncode}):" \
                f"\n{out0}"
            assert "LEADER_SUICIDE" in out0, out0
            # the restarted leader binds the dead process's port; it
            # holds its node back until the winner's GO, so starting it
            # now (mid-election) is safe
            rejoin = launch(["rejoin", "--dir", d_lead, "--rdv", rdv])
            procs.append(rejoin)
            out_r = rejoin.communicate(timeout=WAIT_S + 20)[0]
            out1 = f1.communicate(timeout=WAIT_S + 20)[0]
            out2 = f2.communicate(timeout=WAIT_S + 20)[0]
            every = (f"--- rejoin\n{out_r}\n--- follower 1\n{out1}\n"
                     f"--- follower 2\n{out2}")
            assert rejoin.returncode == 0, f"rejoin failed:\n{every}"
            assert f1.returncode == 0, f"follower 1 failed:\n{every}"
            assert f2.returncode == 0, f"follower 2 failed:\n{every}"

            w_out, l_out = ((out1, out2) if "PROMOTED" in out1
                            else (out2, out1))
            assert "PROMOTED" in w_out and "PROMOTED" not in l_out, \
                f"expected exactly one promotion:\n{out1}\n{out2}"
            ballot_applied = int(_field(w_out, "PROMOTED",
                                        "ballot_applied"))
            clean = launch(["clean", "--dir", d_clean, "--records",
                            str(ballot_applied + 1)])
            procs.append(clean)
            out_c = clean.communicate(timeout=WAIT_S + 20)[0]
            assert clean.returncode == 0, f"clean twin failed:\n{out_c}"
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()

    # no acked write lost: every seq the client saw acked is inside the
    # winner's ballot prefix (a quorum holds it, and the election picks
    # the survivor with the highest applied seq)
    acked = [int(s) for s in re.findall(r"ACKED seq=(\d+)", out0)]
    assert len(acked) == KILL_AT_ACKS and max(acked) <= ballot_applied, \
        f"acked={acked} ballot_applied={ballot_applied}\n{out0}\n{w_out}"
    elected_in = (float(_field(w_out, "PROMOTED", "wall"))
                  - float(_field(out0, "LEADER_SUICIDE", "wall")))
    assert elected_in < 2 * HB_TIMEOUT, \
        f"election took {elected_in:.2f}s >= {2 * HB_TIMEOUT}s\n{w_out}"
    winner = int(_field(w_out, "PROMOTED", "rank"))
    votes = dict(pair.split(":") for pair
                 in _field(w_out, "PROMOTED", "votes").split(";"))
    assert int(votes[str(winner)]) == max(int(a) for a in votes.values())
    assert int(_field(w_out, "PROMOTED", "term")) == 1, w_out
    crc_prom = _field(w_out, "PROMOTED", "crc")
    crc_clean = _field(out_c, "CLEAN_OK", "crc")
    assert crc_prom == crc_clean, \
        f"promoted prefix diverged from the clean twin: {crc_prom} != " \
        f"{crc_clean}"
    t_pre = int(_field(w_out, "PROMOTED", "traces_pre"))
    t_post = int(_field(w_out, "PROMOTED", "traces_post"))
    assert t_post == t_pre, f"trace after the promotion: {t_pre}->{t_post}"
    assert int(_field(l_out, "REDIRECT", "leader")) == winner, l_out
    crc_final = _field(w_out, "WINNER_FINAL", "crc")
    assert _field(l_out, "LOSER_OK", "crc") == crc_final, \
        f"loser diverged\n{l_out}\n{w_out}"
    assert _field(out_r, "REJOIN_OK", "crc") == crc_final, \
        f"rejoined leader diverged\n{out_r}\n{w_out}"
    assert _field(out_r, "REJOIN_OK", "fenced") == "TermFencedError"
    divergence = int(_field(out_r, "REJOIN_OK", "divergence"))
    assert divergence == ballot_applied + 1, out_r
    truncated = int(_field(out_r, "REJOIN_OK", "truncated"))
    assert truncated >= 1, out_r
    assert int(_field(out_r, "REJOIN_OK", "term")) == 1, out_r
    print(f"FAILOVER_CHAOS_OK winner={winner} elected_in={elected_in:.2f} "
          f"acked={len(acked)} ballot_applied={ballot_applied} "
          f"truncated={truncated} crc={crc_final}", flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("role", choices=["leader", "follower", "rejoin",
                                    "clean", "orchestrate"])
    p.add_argument("--dir")
    p.add_argument("--rdv")
    p.add_argument("--rank", type=int, default=None)
    p.add_argument("--records", type=int, default=None)
    a = p.parse_args(argv)
    if a.role == "orchestrate":
        orchestrate()
    elif a.role == "clean":
        run_clean(a.dir, a.records)
    elif a.role == "leader":
        run_leader(a.dir, a.rdv)
    elif a.role == "rejoin":
        run_rejoin(a.dir, a.rdv)
    else:
        assert a.rank in (1, 2)
        run_follower(a.dir, a.rdv, a.rank)
    return 0


if __name__ == "__main__":
    sys.exit(main())
