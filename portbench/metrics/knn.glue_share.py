"""Share of the window's device time spent outside the ``fused_topk``
kernels named here (the split walk and the merge of its lists): the
bf16 splits of queries and database, copies, %."""

KERNELS = ("fused_topk_wgmma", "fused_topk_kernel", "merge_splits_kernel")


def read(r):
    total = r.trace.device_seconds()
    topk = r.trace.kernel_seconds(KERNELS, "knn.glue_share")
    if total <= 0 or topk is None:
        return None
    return 100.0 * (1.0 - topk / total)
