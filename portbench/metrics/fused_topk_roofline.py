"""The ``fused_topk`` kernels' share of their roofline, %: each call's
bound (``roofline.knn_topk`` at the configuration's tier) times the
calls, over the device time of the kernels named here (those of the
program's ``csrc/fused_topk.cu``: the split walk at each tier and the
merge of the splits' lists)."""

KERNELS = ("fused_topk_wgmma", "fused_topk_kernel", "merge_splits_kernel")


def read(r):
    per_call = r.counts.get("fused_topk_bound_s_per_call", 0.0)
    seconds = r.trace.kernel_seconds(KERNELS, "fused_topk_roofline")
    if per_call <= 0 or seconds is None:
        return None
    return 100.0 * per_call * r.window.counts["calls"] / seconds
