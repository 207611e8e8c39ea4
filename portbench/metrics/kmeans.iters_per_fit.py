"""Lloyd iterations a fit, as ``kmeans_fit`` returns them (its
``n_iter``), averaged over the window's fits."""


def read(r):
    fits = r.window.counts.get("fits", 0)
    return r.window.counts["lloyd_iters"] / fits if fits else None
