"""The yardstick's arithmetic against shapes worked by hand."""

import pytest

from portbench import roofline


def test_knn_topk_at_the_flat_cell():
    w = roofline.knn_topk(10_000, 1_000_000, 128, 10, "high")
    # three bf16 products of 2 * 1e4 * 1e6 * 128
    assert w.flops == pytest.approx(7.68e12)
    assert w.bytes == (10_000 + 1_000_000) * 128 * 4 + 10_000 * 10 * 8
    assert w.bound_s() == pytest.approx(7.68e12 / 989e12)   # 7.765 ms


def test_tiers_change_the_operations_and_the_peak():
    hi = roofline.knn_topk(64, 1024, 128, 10, "high")
    lo = roofline.knn_topk(64, 1024, 128, 10, "default")
    f32 = roofline.knn_topk(64, 1024, 128, 10, "highest")
    assert hi.flops == 3 * lo.flops and lo.flops == f32.flops
    assert f32.peak_flops == 67e12 and hi.peak_flops == 989e12
    with pytest.raises(ValueError):
        roofline.knn_topk(1, 1, 1, 1, "tf32")


def test_lloyd_pass_matches_the_kernel_tables_bound():
    w = roofline.lloyd_pass(1_000_000, 1024, 128, "high")
    assert w.bound_s() == pytest.approx(0.795e-3, rel=1e-3)   # ops-bound
    assert w.flops / w.peak_flops > w.bytes / roofline.HBM_BYTES_PER_S


def test_ivf_search_counts_real_rows_once():
    # 2 queries, 4 lists of d = 2, 3 probed-row products in all, the
    # union of probed lists 3 rows, k = 1
    w = roofline.ivf_search(2, 4, 2, 1, probed_rows=3, union_rows=3,
                            tier="default")
    assert w.flops == 2 * 2 * 4 * 2 + 2 * 3 * 2
    assert w.bytes == (2 + 4) * 2 * 4 + 3 * (2 * 4 + 4) + 2 * 1 * 8
    assert w.bound_s() == w.bytes / 3.35e12                   # bytes-bound

