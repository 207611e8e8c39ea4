"""The reduction of a trace to device ops, busy time and idle gaps,
on hand-made events ``(name, on_device, start_us, duration_us)``."""

import pytest

from portbench import harness, trace

EVENTS = [
    ("window", False, 0.0, 100.0),
    ("knn", False, 0.0, 40.0),            # a benchmark span
    ("knn", True, 1.0, 38.0),             # its device-side copy
    ("prog.stage", False, 5.0, 20.0),     # a program's span
    ("prog.stage", True, 6.0, 18.0),      # and its copy
    ("aten::mm", False, 6.0, 1.0),
    ("void gemm<float>", True, 10.0, 10.0),
    ("fused_topk_wgmma<2, 0>", True, 20.0, 10.0),
    ("merge_splits_kernel", True, 30.0, 5.0),
    ("Memcpy DtoH", True, 90.0, 20.0),    # runs past the window's end
]


def summary():
    return trace.summarize_events(EVENTS, {"knn", "window"})


def test_copies_of_host_ranges_are_not_device_ops():
    s = summary()
    assert sorted(n for n, _, _ in s.device) == [
        "Memcpy DtoH", "fused_topk_wgmma<2, 0>", "merge_splits_kernel",
        "void gemm<float>"]
    # 10..35 and 90..100 inside the window
    assert s.busy_s == pytest.approx(35e-6)
    assert s.window_s == pytest.approx(100e-6)


def test_idle_gaps_are_named_by_the_benchmarks_spans():
    gaps = dict(summary().idle_gaps())
    # 0..10 in "knn"; 35..90 named at its middle, after "knn" ended
    assert gaps["knn"] == pytest.approx(10e-6)
    assert gaps[trace.OUTSIDE] == pytest.approx(55e-6)
    assert "window" not in gaps


def test_kernel_seconds_match_names_as_words():
    s = summary()
    assert s.kernel_seconds(("fused_topk_wgmma", "merge_splits_kernel"),
                            "m") == pytest.approx(15e-6)
    assert s.kernel_seconds(("gemm",), "m") == pytest.approx(10e-6)


def test_kernels_that_never_ran_give_no_reading(capsys):
    assert summary().kernel_seconds(("lloyd_sums",), "a_roofline") is None
    assert "a_roofline" in capsys.readouterr().err


def test_a_trace_without_the_window_is_refused():
    with pytest.raises(RuntimeError, match="window"):
        trace.summarize_events(EVENTS[1:], set())


@pytest.mark.parametrize("metric", ["fused_topk_roofline",
                                    "fused_lloyd_roofline",
                                    "knn.glue_share"])
def test_a_kernel_share_with_its_kernels_absent_is_silent_not_zero(
        metric, capsys):
    class Window:
        counts = {"calls": 3}

    reading = harness.Reading(
        "cell", Window, trace.summarize_events(EVENTS, set()),
        {"fused_topk_bound_s_per_call": 1e-3, "lloyd_bound_s": 1e-3})
    value = harness.load_reader(metric)(reading)
    if metric == "fused_lloyd_roofline":
        assert value is None and metric in capsys.readouterr().err
    else:
        assert value > 0          # this trace holds fused_topk kernels
