"""Subprocess worker for the port's streaming SIGKILL witness
(tests/test_torch_streaming.py); imports torch and the port only.

Runs one fixed mutation sequence on a journaled
:class:`raft_tpu_torch.neighbors.streaming.StreamingIndex` on the CPU:

    build(seed) -> insert 24 -> delete every 3rd of ids 0..39
    -> [arm ingest.* here] -> insert 16 -> [arm compact.* here] -> compact

``--dir D`` (default mode)
    Run the sequence. With ``--crash NAME`` the named
    ``FaultInjector.crash_point`` is armed (``--mode kill`` sends a real
    SIGKILL: no atexit, no finally). Without a crash it prints the three
    content CRCs the parent scores a recovery against:
    ``after_delete after_insert2 final``.

``--dir D --recover``
    Recover the index from ``D`` twice (two independent
    ``StreamingIndex.recover`` calls) and print both CRCs.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np  # noqa: E402

N_DB, DIM, N_LISTS = 160, 8, 8


def _res():
    from raft_tpu_torch import device_resources

    return device_resources("cpu")


def _sequence(directory, crash=None, mode="kill"):
    from raft_tpu_torch.comms.faults import FaultInjector
    from raft_tpu_torch.neighbors import streaming

    faults = FaultInjector()
    rng = np.random.default_rng(7)
    db = rng.normal(size=(N_DB, DIM)).astype(np.float32)
    idx = streaming.stream_build(_res(), db, N_LISTS, seed=0,
                                 max_iter=4, directory=directory,
                                 faults=faults)
    idx.insert(rng.normal(size=(24, DIM)).astype(np.float32))
    idx.delete(np.arange(0, 40, 3))
    crc_after_delete = idx.content_crc()
    if crash and crash.startswith("ingest."):
        faults.arm_crash(crash, mode=mode)
    idx.insert(rng.normal(size=(16, DIM)).astype(np.float32))
    crc_after_insert2 = idx.content_crc()
    if crash and crash.startswith("compact."):
        faults.arm_crash(crash, mode=mode)
    idx.compact(reason="chaos")
    return crc_after_delete, crc_after_insert2, idx.content_crc()


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--dir", required=True)
    p.add_argument("--crash", default=None)
    p.add_argument("--mode", default="kill")
    p.add_argument("--recover", action="store_true")
    a = p.parse_args(argv)
    if a.recover:
        from raft_tpu_torch.neighbors.streaming import StreamingIndex

        first = StreamingIndex.recover(_res(), a.dir).content_crc()
        second = StreamingIndex.recover(_res(), a.dir).content_crc()
        print(f"{first} {second}")
        return 0
    crcs = _sequence(a.dir, a.crash, a.mode)
    print(" ".join(str(c) for c in crcs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
