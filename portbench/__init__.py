"""The port's benchmark: cells of ``BENCHMARK.json`` run against
``raft_tpu_torch`` on one or more CUDA cards.

Everything a cell needs is found by name: its workload file in
``workloads/``, its configuration in ``configs/``, its traffic mix in
``traffic/``, its driver in ``drivers/`` and each per-layer metric's
reader in ``metrics/``. ``reference/`` holds the plain PyTorch
computations that decide ``correct``. Run one cell with::

    python3 -m portbench.run --workload sift1m-flat.batch --seed 7 \\
        --seconds 10 --trace 0
"""
