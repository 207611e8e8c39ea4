"""Faults planted in the program under a run, to show that ``correct``
catches them (the fault tests at a small size on the CPU, and
``calibrate`` at the cells' sizes on the card). Each ``plant_<name>``
patches the program and returns a function that undoes the patch.

- ``altered``: one answer changed where it is produced (a search's
  first nearest id, a fit's first label);
- ``half``: half of the batch left out (a search answers the first half
  of its queries and repeats them for the rest; a fit runs on every
  other row and its labels and inertia are worked out for all);
- ``unchanged``: a Lloyd step that returns its centroids unchanged.

Which of them a cell can have, and under what names, its driver says
(``Driver.FAULTS``): the IVF cell has the k-means faults under its
index's build besides its search's.
"""

from __future__ import annotations

import torch


def _swap(obj, name, new):
    old = getattr(obj, name)
    setattr(obj, name, new)
    return lambda: setattr(obj, name, old)


def _altered(d, ids):
    ids = ids.clone()
    ids[0, 0] = (ids[0, 0] + 1) % 4096
    return d, ids


def _half(fn, queries):
    h = max(1, queries.shape[0] // 2)
    d, ids = fn(queries[:h])
    reps = -(-queries.shape[0] // h)
    return (d.repeat(reps, 1)[:queries.shape[0]],
            ids.repeat(reps, 1)[:queries.shape[0]])


def plant_search(fault: str, what: str = "knn"):
    """``what``: 'knn' (``neighbors.knn``, also under the serving
    executor) or 'ivf' (``ivf_flat.search``)."""
    if what == "knn":
        import raft_tpu_torch.neighbors as owner

        name = "knn"
    else:
        from raft_tpu_torch.neighbors import ivf_flat as owner

        name = "search"
    real = getattr(owner, name)

    def broken(res, fixed, q, *rest, **kw):
        # knn(res, db, queries, k, ...) and search(res, index, queries,
        # k, nprobe) both take the queries third
        def call(qq):
            return real(res, fixed, qq, *rest, **kw)

        if fault == "altered":
            return _altered(*call(q))
        if fault == "half":
            return _half(call, q)
        raise ValueError(fault)

    return _swap(owner, name, broken)


def plant_kmeans(fault: str):
    import raft_tpu_torch.cluster.kmeans as km

    if fault == "unchanged":
        real_step = km.lloyd_step_prepared

        def step(ops, c, *, m):
            _, inertia, labels = real_step(ops, c, m=m)
            return c, inertia, labels

        return _swap(km, "lloyd_step_prepared", step)
    real_fit = km.kmeans_fit

    def fit(res, params, x, **kw):
        if fault == "half":
            c, _, _, n = real_fit(res, params, x[::2], **kw)
            dist, labels = km._assign(x, c)
            return c, dist.sum(), labels, n
        if fault == "altered":
            c, inertia, labels, n = real_fit(res, params, x, **kw)
            labels = labels.clone()
            labels[0] = (labels[0] + 1) % c.shape[0]
            return c, inertia, labels, n
        raise ValueError(fault)

    return _swap(km, "kmeans_fit", fit)


def plant(driver, fault: str):
    """Plant ``fault`` under a cell whose driver class is ``driver``:
    each driver names the faults its cell can have in ``FAULTS``."""
    if fault not in driver.FAULTS:
        raise ValueError(f"no fault {fault!r} for this cell; it has "
                         f"{sorted(driver.FAULTS)}")
    return driver.FAULTS[fault]()
