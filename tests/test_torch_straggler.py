"""The port's straggler scheduler (``runtime/straggler.py``), after ``tests/test_straggler.py``.

The scheduler is host-side thread logic.  Where the reference sleeps a
straggler past a deadline and asserts on wall time, these tests hold the
straggler's first attempt on a ``threading.Event`` that the test sets
only after the schedule returned, so no assertion depends on how loaded
the host is.  Each case also runs the reference's scheduler on
the same units and expects the same results.
"""

import threading
import time

from repro.runtime.straggler import run_with_speculation as ref_run_with_speculation
from repro_torch.runtime.straggler import run_with_speculation


def _wait_for_thread_cleanup(prefix="lp-straggler", timeout=10.0):
    """Poll until no thread with the given name prefix remains."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if not [t for t in threading.enumerate() if t.name.startswith(prefix)]:
            return True
        time.sleep(0.02)
    return False


def test_results_correct_without_stragglers():
    # The deadline needs more finished units than there are: it never
    # arms, so nothing is re-dispatched, however slow the host.
    units = list(range(6))
    for run in (run_with_speculation, ref_run_with_speculation):
        report = run(units, lambda payload, worker: payload * 2, n_workers=3,
                     min_done_for_deadline=len(units) + 1)
        assert [r.value for r in report.results] == [0, 2, 4, 6, 8, 10]
        assert [r.unit for r in report.results] == units
        assert report.respawned == 0


def _held_straggler(unit):
    """A work function whose first attempt at ``unit`` blocks until the test
    sets ``release``; returns ``(solve, calls, release)``."""
    calls = {}
    lock = threading.Lock()
    release = threading.Event()

    def solve(payload, worker):
        with lock:
            first = payload not in calls
            calls[payload] = calls.get(payload, 0) + 1
        if payload == unit and first:
            release.wait(timeout=30.0)
        else:
            time.sleep(0.005)
        return payload * 10

    return solve, calls, release


def test_straggler_is_respawned_and_result_correct():
    for run in (run_with_speculation, ref_run_with_speculation):
        solve, calls, release = _held_straggler(3)
        try:
            report = run(list(range(6)), solve, n_workers=6, alpha=3.0,
                         min_done_for_deadline=2, poll=0.005)
        finally:
            release.set()
        assert [r.value for r in report.results] == [i * 10 for i in range(6)]
        assert report.respawned >= 1
        assert calls[3] >= 2  # the straggler really was dispatched again
        # Unit 3's result is the twin's: the batch did not wait for the
        # held first attempt.
        assert report.results[3].speculative


def test_max_speculative_zero_disables_respawn():
    release = threading.Event()

    def solve(payload, worker):
        if payload == 3:
            release.wait(timeout=30.0)
        return payload

    # Let the held unit go once the others are long done; with no
    # speculation allowed the schedule must wait for it.
    timer = threading.Timer(0.2, release.set)
    timer.start()
    try:
        report = run_with_speculation(list(range(6)), solve, n_workers=6, alpha=2.0,
                                      min_done_for_deadline=2, poll=0.005, max_speculative=0)
    finally:
        release.set()
        timer.cancel()
    assert report.respawned == 0
    assert [r.value for r in report.results] == list(range(6))
    assert not report.results[3].speculative


def test_no_thread_leak_after_return():
    """The pool's threads are collected once the held loser ends, not
    stranded for the life of the process."""
    assert _wait_for_thread_cleanup(), "leftover pools from earlier tests"
    for _ in range(3):
        solve, _, release = _held_straggler(0)
        report = run_with_speculation(list(range(4)), solve, n_workers=4, poll=0.005)
        assert report.results[0].speculative
        release.set()  # the held loser ends only now, after the call returned
    assert _wait_for_thread_cleanup(), (
        "lp-straggler threads still alive after their stragglers finished")


def test_delay_injected_report_fields():
    report = run_with_speculation([0, 1], lambda p, w: p, n_workers=2)
    assert report.wall_time >= 0.0
    for r in report.results:
        assert r.elapsed >= 0.0
        assert isinstance(r.speculative, bool)
