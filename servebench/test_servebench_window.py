"""The window's arithmetic on hand-made requests."""
from types import SimpleNamespace

import pytest

from servebench import window
from servebench.window import Served


def req(arrival, schedule=0.0, first=0.0, tokens=()):
    return SimpleNamespace(arrival_time=arrival, schedule_time=schedule,
                           first_token_time=first, token_times=list(tokens))


WS, WE = 10.0, 20.0


def test_ttft_from_due_time_and_unfinished_at_wait_so_far():
    served = [
        Served(9.0, req(9.0, 9.1, 9.5)),           # due before the window
        Served(11.0, req(11.5, 11.6, 12.0)),        # submitted late
        Served(15.0, req(15.0, 16.0, 0.0)),         # no first token
        Served(18.0, None),                         # never submitted
        Served(19.0, req(19.0, 19.2, 20.5)),        # first token too late
        Served(20.0, req(20.0)),                    # due at the close
    ]
    assert window.ttfts(served, WS, WE) == pytest.approx(
        [1.0, 5.0, 2.0, 1.0])


def test_queue_wait_from_arrival():
    served = [Served(11.0, req(11.5, 11.6, 12.0)),
              Served(15.0, req(15.0, 0.0)),
              Served(18.0, None),
              Served(19.0, req(19.0, 20.4))]
    assert window.queue_waits(served, WS, WE) == pytest.approx(
        [0.1, 5.0, 2.0, 1.0])


def test_token_gaps_end_inside_the_window():
    served = [Served(5.0, req(5.0, 5.0, 8.0, [9.0, 10.5, 12.0, 21.0])),
              Served(12.0, req(12.0, 12.0, 13.0, [13.25])),
              Served(15.0, req(15.0, 15.0, 0.0))]
    assert sorted(window.token_gaps(served, WS, WE)) == pytest.approx(
        [0.25, 1.5, 1.5])


def test_percentile_interpolates_like_numpy():
    np = pytest.importorskip("numpy")
    xs = [3.0, 1.0, 4.0, 1.5, 9.0, 2.6, 5.0]
    for p in (0, 37.5, 50, 95, 100):
        assert window.percentile(xs, p) == pytest.approx(
            float(np.percentile(xs, p)))
    assert window.percentile([], 50) is None
