"""The IVF-Flat searches' share of their roofline, %: the summed bound
of the window's calls (``roofline.ivf_search``: the coarse product and
the products with the probed lists' real rows; the queries, centroids
and the union of probed rows read once) over all device time of the
window, which is the searches' alone."""


def read(r):
    bound = r.counts.get("ivf_search_bound_s", 0.0)
    seconds = r.trace.device_seconds()
    if bound <= 0 or seconds <= 0:
        return None
    return 100.0 * bound / seconds
