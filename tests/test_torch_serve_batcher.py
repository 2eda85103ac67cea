"""The port's micro-batcher (``h2o_tpu_torch.serve.batcher``) held against
``h2o_tpu.serve.batcher`` on the same scripted traffic:

- requests queued behind a held batch coalesce into the next one, up to
  ``max_batch`` rows, in the same batches as the reference's, and every
  future gets its own rows' answers (no mixing);
- ``QueueFull`` at the cap; a queued request whose deadline passes on an
  injected clock fails as ``TimeoutError``; ``stop`` fails the queued
  ones and later submits with ``BatcherStopped``; a failing batch fans
  its error out;
- ``AdaptiveBatchTuner`` takes the reference's decisions for the same
  ``observe`` sequences, only ever powers of two within its bounds;
- no lock cycle is witnessed (the suite runs with the witness on).

Every wait has a timeout; the worker is held by events, never by sleeps.
"""

import threading

import numpy as np
import pytest

from h2o_tpu.core import resilience as j_res
from h2o_tpu.serve import batcher as j_b

from h2o_tpu_torch.core import lockwitness as p_lw
from h2o_tpu_torch.core import resilience as p_res
from h2o_tpu_torch.serve import batcher as p_b

WAIT = 10.0
PKGS = [(j_b, j_res), (p_b, p_res)]


class _Gate:
    """A ``score_fn`` that answers each row with ``10 * row["i"]`` and
    holds its first call until released; records every batch."""

    def __init__(self, fail_on=None):
        self.entered = threading.Event()
        self.release = threading.Event()
        self.batches = []
        self.fail_on = fail_on

    def __call__(self, rows):
        self.batches.append([r["i"] for r in rows])
        if len(self.batches) == 1:
            self.entered.set()
            assert self.release.wait(WAIT)
        if self.fail_on is not None and self.fail_on in \
                [r["i"] for r in rows]:
            raise RuntimeError("batch failed")
        return np.array([[10.0 * r["i"]] for r in rows])


def _req(start, n):
    return [{"i": start + k} for k in range(n)]


def _coalesce(bmod, sizes, max_batch):
    gate = _Gate()
    seen = []
    mb = bmod.MicroBatcher(gate, max_batch=max_batch, max_delay_ms=500.0,
                           queue_cap=64, name="coalesce",
                           on_batch=lambda k, n: seen.append((k, n)))
    try:
        first = mb.submit(_req(0, 1))
        assert gate.entered.wait(WAIT)
        futs, start = [], 100
        for n in sizes:
            futs.append((start, n, mb.submit(_req(start, n))))
            start += 100
        assert mb.pending == len(sizes) + 1
        gate.release.set()
        assert first.result(WAIT).tolist() == [[0.0]]
        for s, n, f in futs:
            assert f.result(WAIT).tolist() == \
                [[10.0 * (s + k)] for k in range(n)]
    finally:
        mb.stop(timeout=WAIT)
    return gate.batches, seen


@pytest.mark.parametrize("max_batch", [1, 4, 16])
def test_coalescing_equals_reference_without_mixing(max_batch):
    sizes = [1, 3, 2, 1, 4, 1, 1, 2]
    got = _coalesce(p_b, sizes, max_batch)
    want = _coalesce(j_b, sizes, max_batch)
    assert got == want
    batches, seen = got
    assert sum(len(b) for b in batches) == 1 + sum(sizes)
    if max_batch > 1:
        assert max(k for k, _n in seen) > 1          # requests coalesced
    # a batch closes once it holds max_batch rows; its last request
    # (at most 4 rows here) may carry it past
    assert all(n < max_batch + 4 for _k, n in seen)


def _queue_full(bmod):
    gate = _Gate()
    mb = bmod.MicroBatcher(gate, max_batch=1, max_delay_ms=0.0,
                           queue_cap=3, name="full")
    out = []
    try:
        futs = [mb.submit(_req(0, 1))]
        assert gate.entered.wait(WAIT)
        for i in range(1, 5):
            try:
                futs.append(mb.submit(_req(i, 1)))
                out.append("ok")
            except bmod.QueueFull as e:
                out.append(("QueueFull", str(e)))
        mb.configure(queue_cap=4)
        futs.append(mb.submit(_req(9, 1)))
        gate.release.set()
        out.append([f.result(WAIT).tolist() for f in futs])
        out.append(mb.pending)
    finally:
        mb.stop(timeout=WAIT)
    return out


def test_queue_full_at_the_cap():
    got, want = _queue_full(p_b), _queue_full(j_b)
    assert got == want
    assert got[:4] == ["ok", "ok", ("QueueFull", got[2][1]),
                       ("QueueFull", got[2][1])]
    assert got[-1] == 0


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        return self.t


def _deadline(bmod, rmod, monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(rmod, "time", clock)
    gate = _Gate()
    mb = bmod.MicroBatcher(gate, max_batch=8, max_delay_ms=500.0,
                           queue_cap=8, name="dl")
    try:
        head = mb.submit(_req(0, 1))
        assert gate.entered.wait(WAIT)
        late = mb.submit(_req(1, 1), deadline=rmod.Deadline(0.5))
        ok = mb.submit(_req(2, 1), deadline=rmod.Deadline(5.0))
        never = mb.submit(_req(3, 1), deadline=rmod.Deadline(0))
        clock.t += 1.0                   # the 0.5 s budget is spent
        gate.release.set()
        head.result(WAIT)
        with pytest.raises(TimeoutError) as ei:
            late.result(WAIT)
        out = [str(ei.value), ok.result(WAIT).tolist(),
               never.result(WAIT).tolist(), gate.batches]
    finally:
        mb.stop(timeout=WAIT)
    return out


def test_queued_deadline_expires_as_timeout(monkeypatch):
    got = _deadline(p_b, p_res, monkeypatch)
    want = _deadline(j_b, j_res, monkeypatch)
    assert got == want
    assert "0.5s deadline while queued on dl" in got[0]
    assert got[3] == [[0], [2, 3]]


def _stop(bmod):
    gate = _Gate()
    mb = bmod.MicroBatcher(gate, max_batch=1, max_delay_ms=0.0,
                           queue_cap=8, name="gone")
    head = mb.submit(_req(0, 1))
    assert gate.entered.wait(WAIT)
    queued = [mb.submit(_req(i, 1)) for i in (1, 2)]
    mb.stop(timeout=0.05)                # the worker is still held
    out = [mb.stopped]
    for f in queued:
        with pytest.raises(bmod.BatcherStopped) as ei:
            f.result(WAIT)
        out.append(str(ei.value))
    with pytest.raises(bmod.BatcherStopped) as ei:
        mb.submit(_req(5, 1))
    out.append(str(ei.value))
    gate.release.set()
    out.append(head.result(WAIT).tolist())
    mb._thread.join(WAIT)
    out.append(mb._thread.is_alive())
    return out


def test_stop_fails_queued_and_later_requests():
    got, want = _stop(p_b), _stop(j_b)
    assert got == want
    assert got[0] is True and got[-1] is False


def _fanout(bmod):
    gate = _Gate(fail_on=2)
    mb = bmod.MicroBatcher(gate, max_batch=8, max_delay_ms=500.0,
                           queue_cap=8, name="err")
    try:
        head = mb.submit(_req(0, 1))
        assert gate.entered.wait(WAIT)
        a, b = mb.submit(_req(1, 1)), mb.submit(_req(2, 2))
        gate.release.set()
        out = [head.result(WAIT).tolist()]
        for f in (a, b):
            with pytest.raises(RuntimeError, match="batch failed"):
                f.result(WAIT)
        after = mb.submit(_req(7, 1))
        out += [after.result(WAIT).tolist(), mb.pending, gate.batches]
    finally:
        mb.stop(timeout=WAIT)
    return out


def test_failed_batch_fans_out_its_error():
    got, want = _fanout(p_b), _fanout(j_b)
    assert got == want
    assert got[2] == 0


# -- the adaptive tuner ------------------------------------------------------

def _tuner_trace(bmod, seed, lo, hi, window, max_batch, cap):
    mb = bmod.MicroBatcher(lambda rows: None, max_batch=max_batch,
                           max_delay_ms=2.0, queue_cap=cap, name="tune")
    try:
        t = bmod.AdaptiveBatchTuner(mb, lo=lo, hi=hi, window=window)
        rng = np.random.default_rng(seed)
        trace = [(t.lo, t.hi, t.window)]
        for phase in range(6):
            busy = phase % 2 == 0
            for _ in range(int(rng.integers(window, 4 * window))):
                q = int(rng.integers(cap // 2, cap + 1)) if busy else \
                    int(rng.integers(0, 2))
                rows = int(rng.integers(1, 2 * max_batch + 1)) if busy \
                    else 1
                t.observe(q, rows)
                trace.append((mb.max_batch, round(mb.max_delay_ms, 9)))
        trace.append(t.stats())
    finally:
        mb.stop(timeout=WAIT)
    return trace


TUNER_CASES = [(0, None, None, 8, 4, 16), (1, 2, 64, 4, 8, 32),
               (2, 1, 16, 3, 3, 10), (3, 4, 128, 8, 32, 64),
               (4, 3, 100, 2, 6, 8), (5, 8, 8, 5, 8, 16)]


@pytest.mark.parametrize("case", TUNER_CASES)
def test_tuner_decisions_equal_reference(case):
    got = _tuner_trace(p_b, *case)
    want = _tuner_trace(j_b, *case)
    assert got == want
    lo, hi = got[0][:2]
    decided = False
    for mb, _delay in got[1:-1]:
        decided = decided or mb != case[4]
        if decided:          # the configured size stands until a decision
            assert mb & (mb - 1) == 0 and lo <= mb <= hi, (mb, lo, hi)


def test_tuner_bounds_read_the_environment(monkeypatch):
    monkeypatch.setenv("H2O_TPU_SERVE_MIN_BATCH", "3")
    monkeypatch.setenv("H2O_TPU_SERVE_MAX_BATCH", "50")
    got = []
    for bmod in (p_b, j_b):
        mb = bmod.MicroBatcher(lambda rows: None, name="env")
        try:
            t = bmod.AdaptiveBatchTuner(mb)
            got.append((t.lo, t.hi, t.window, t.base_delay_ms))
        finally:
            mb.stop(timeout=WAIT)
    assert got[0] == got[1] == (4, 64, 8, 2.0)


def test_no_lock_cycle_witnessed():
    assert p_lw.enabled()
    assert p_lw.registry().find_cycles() == []
    assert p_lw.registry().held_dispatches() == []
