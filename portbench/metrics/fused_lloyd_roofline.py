"""The ``fused_lloyd`` kernels' share of their roofline, %: a Lloyd
pass's bound (``roofline.lloyd_pass``) times the Lloyd iterations the
window's fits report, over the device time of the kernels named here
(those of the program's ``csrc/fused_lloyd.cu``: the argmin at each
tier and the counting sort and sums of the update)."""

KERNELS = ("lloyd_argmin_wgmma", "lloyd_argmin_fma", "lloyd_hist",
           "lloyd_scan_chunks", "lloyd_scan_labels", "lloyd_place",
           "lloyd_sums", "lloyd_fixup")


def read(r):
    bound = r.counts.get("lloyd_bound_s", 0.0)
    seconds = r.trace.kernel_seconds(KERNELS, "fused_lloyd_roofline")
    if bound <= 0 or seconds is None:
        return None
    return 100.0 * bound / seconds
