"""The closed-loop generator walks the query set in blocks."""

from portbench import traffic


def test_closed_loop_blocks_walk_the_set_and_wrap():
    mix = {"query_set": 10, "rows_per_call": 4}
    assert list(traffic.closed_rows(mix, 0)) == [0, 1, 2, 3]
    assert list(traffic.closed_rows(mix, 2)) == [8, 9, 0, 1]


def test_every_block_has_the_calls_rows():
    mix = {"query_set": 10000, "rows_per_call": 256}
    for call in (0, 39, 40, 12345):
        rows = traffic.closed_rows(mix, call)
        assert len(rows) == 256 and rows.min() >= 0 and rows.max() < 10000
