"""The trace arithmetic: busy time as the union of device events, and the
device's idle time given to the span the host was in."""

from __future__ import annotations

import pytest

from portbench import devtrace


def test_busy_time_is_the_union_of_overlapping_events():
    s, e = devtrace.merge([0, 5, 20, 22, 40], [10, 8, 25, 30, 41])
    assert s.tolist() == [0, 20, 40] and e.tolist() == [10, 30, 41]
    assert int((e - s).sum()) == 21


def test_idle_time_goes_to_the_innermost_span():
    s, e = devtrace.merge([10, 50], [20, 60])
    spans = [(0, 100, "outer"), (25, 45, "inner")]
    idle = devtrace.idle_by_span(s, e, 0, 100, spans)
    # gaps [0,10) and [60,100) are the outer span's, [20,50) the inner's
    assert idle == {"outer": 50, "inner": 30}
    assert sum(idle.values()) + 20 == 100


def test_idle_time_outside_every_span():
    s, e = devtrace.merge([10], [20])
    assert devtrace.idle_by_span(s, e, 0, 30, []) == {"(no span)": 20}


@pytest.mark.parametrize("n", [1, 1000])
def test_union_of_many_back_to_back_events(n):
    s, e = devtrace.merge(list(range(0, 2 * n, 2)), list(range(2, 2 * n + 2, 2)))
    assert s.tolist() == [0] and e.tolist() == [2 * n]
