"""The window's rate and tail arithmetic on a synthetic call log with a
stall, and the closed loop itself on the host."""

import pytest

from benchmark import window


def _log():
    """100 calls of 8 frames, one finishing every 10 ms from t = 0.01 s,
    each 20 ms after its submission; call 50 stalls for 500 ms, and every
    later call finishes 500 ms late. The window is [0, 1] s."""
    calls = []
    for k in range(100):
        submit = 0.01 * k - 0.01
        stall = 0.5 if k >= 50 else 0.0
        done = submit + 0.02 + stall
        calls.append(window.Call(k, 8, submit, submit + 0.001, done_s=done))
    return calls


def test_rate_counts_only_frames_done_inside_the_window():
    """The stall costs what it cost: 50 calls inside, and of call 50, the
    next completion (1.01 s), the share of the way from the last completion
    (0.50 s) to it that the window covers; not the 800 frames/s of a rate
    from the first completion to the last."""
    calls = _log()
    inside = [c for c in calls if 0.0 <= c.done_s <= 1.0]
    assert len(inside) == 50  # calls 0-49 finish by 0.5 s; the rest after 1.0 s
    assert window.frames_per_s(calls, 0.0, 1.0) == pytest.approx(
        50 * 8 + 8 * (1.0 - 0.50) / (1.01 - 0.50))
    assert window.frames_per_s(calls, 0.0, 1.0) == pytest.approx(407.843, abs=1e-3)


def test_with_no_completion_after_the_end_the_rate_is_the_frames_done_inside():
    calls = _log()[:50]
    assert window.frames_per_s(calls, 0.0, 1.0) == 50 * 8 / 1.0
    assert window.frames_per_s(calls[:10], 0.0, 0.5) == 10 * 8 / 0.5


@pytest.mark.parametrize("phase", [0.0, 0.013, 0.25, 0.5, 0.77, 0.999])
@pytest.mark.parametrize("every_s", [0.0031, 0.013, 0.4])
def test_a_steady_log_reads_its_rate_whatever_its_phase_against_the_window(phase, every_s):
    """Calls of 8 frames finishing every ``every_s``, from before the window
    to after it, read 8 / ``every_s`` at every phase: no quantum of a call."""
    first = -3 * every_s + phase * every_s
    calls = [window.Call(k, 8, 0.0, 0.0, done_s=first + k * every_s)
             for k in range(int(1.0 / every_s) + 7)]
    assert window.frames_per_s(calls, 0.0, 1.0) == pytest.approx(8 / every_s, rel=1e-9)


def test_tail_sees_the_stall():
    lat = window.latency_ms(_log())
    assert lat[0] == pytest.approx(20.0) and lat[99] == pytest.approx(520.0)
    assert window.percentile(lat, 95) == pytest.approx(520.0)
    assert window.percentile(lat[:50], 95) == pytest.approx(20.0)
    assert window.percentile([3.0], 95) == 3.0
    assert window.enqueue_ms(_log())[0] == pytest.approx(1.0)


def test_closed_loop_keeps_the_pool_order_and_samples_from_the_seed():
    seen = []

    def step(a, b):
        seen.append((a, b))
        return a

    sample = window.Sample(seed=2**31 + 7, pool_batches=2)
    calls, t0, t1 = window.closed_loop(step, [(0, 1), (2, 3)], 4, 0.05, 2,
                                       window.HostClock(), sample, first_index=1)
    assert t1 - t0 == pytest.approx(0.05)
    assert len(calls) == len(seen) >= 4 and calls[0].index == 1
    assert seen[:3] == [(2, 3), (0, 1), (2, 3)]
    assert all(c.done_s >= c.return_s >= c.submit_s for c in calls)
    assert sample.seen == len(calls)
    kept = [i for i, _ in sample.kept]
    assert kept == sorted(kept) and {i % 2 for i in kept} == {0, 1}
    assert calls[-1].index in kept and calls[-2].index in kept
    assert all(out == (0 if i % 2 == 0 else 2) for i, out in sample.kept)
    again = window.Sample(seed=2**31 + 7, pool_batches=2)
    for c in calls:
        again.offer(c.index, None)
    assert [i for i, _ in again.kept] == kept


def test_the_sample_holds_a_draw_and_the_last_call_of_every_batch():
    draws = set()
    for seed in range(40):
        sample = window.Sample(seed, pool_batches=4)
        for index in range(3, 103):
            sample.offer(index, index)
        kept = [i for i, _ in sample.kept]
        assert {i % 4 for i in kept} == {0, 1, 2, 3}
        assert set(range(99, 103)) <= set(kept) and len(kept) <= 8
        assert all(i == out for i, out in sample.kept)
        draws.update(i for i in kept if i < 99)
    assert min(draws) < 30  # the draws reach early calls too
    short = window.Sample(0, pool_batches=4)
    short.offer(0, "a")
    assert short.kept == [(0, "a")]
