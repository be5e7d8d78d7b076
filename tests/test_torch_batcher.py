"""The port's ``DeadlineBatcher`` and ``Request`` against the reference's
(``repro.serving.batcher``): seeded random sequences of ``submit``,
``requeue``, ``pop_one`` and ``next_batch`` drive one batcher of each
package, and every observable must agree: ids, pop order (deadline ties
included), ``rejected``, ``overflowed``, batch deadlines, the metrics
counters and ``requeue``'s error for a request never admitted."""

import collections

import numpy as np
import pytest

from repro.serving import batcher as jbt
from repro_torch.serving import batcher as tbt


class Counters:
    """The duck-typed metrics hook: ``counter(name).inc()``."""

    def __init__(self):
        self.counts = collections.Counter()

    def counter(self, name):
        counts = self.counts

        class _C:
            def inc(self):
                counts[name] += 1

        return _C()


def ids(reqs):
    return [(r.req_id, r.deadline, r.payload) for r in reqs]


def drive(mod, seed, max_queue, min_feasible, preassign):
    """One seeded sequence of operations on ``mod``'s batcher; returns
    everything it observed."""
    rng = np.random.default_rng(seed)
    metrics = Counters()
    b = mod.DeadlineBatcher(batch_size=3, min_feasible_latency=min_feasible,
                            max_queue=max_queue, metrics=metrics)
    log, popped, now, n = [], [], 0.0, 0
    for _ in range(200):
        op = rng.choice(["submit", "submit", "requeue", "pop", "batch"])
        if op == "submit":
            # Deadlines on a coarse grid, so ties are common.
            req = mod.Request(deadline=now + float(rng.integers(0, 6)) * 0.25,
                              payload=n, arrival=now,
                              req_id=1000 + n if preassign and n % 4 == 0
                              else None)
            n += 1
            log.append(("submit", b.submit(req), req.req_id))
        elif op == "requeue" and popped:
            req = popped.pop(int(rng.integers(len(popped))))
            b.requeue(req)
            log.append(("requeue", req.req_id))
        elif op == "pop":
            req = b.pop_one(now)
            if req is not None:
                popped.append(req)
            log.append(("pop", None if req is None else req.req_id))
        elif op == "batch":
            out = b.next_batch(now)
            if out is not None:
                popped.extend(out[0])
                out = (ids(out[0]), out[1])
            log.append(("batch", out))
        log.append(("len", len(b)))
        now += float(rng.uniform(0.0, 0.3))
    return dict(log=log, rejected=ids(b.rejected),
                overflowed=ids(b.overflowed), counts=dict(metrics.counts))


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("max_queue", [None, 4])
@pytest.mark.parametrize("min_feasible", [0.0, 0.5])
def test_random_sequences_match_reference(seed, max_queue, min_feasible):
    got = drive(tbt, seed, max_queue, min_feasible, preassign=seed % 2 == 1)
    want = drive(jbt, seed, max_queue, min_feasible, preassign=seed % 2 == 1)
    assert got == want
    if min_feasible:
        assert got["rejected"]
    if max_queue:
        assert got["overflowed"]


def test_edf_ties_break_by_submission_and_ids_are_per_batcher():
    for mod in (tbt, jbt):
        a, b = mod.DeadlineBatcher(4), mod.DeadlineBatcher(4)
        for d in (2.0, 1.0, 2.0, 1.0):
            a.submit(mod.Request(deadline=d))
        b.submit(mod.Request(deadline=5.0))
        batch, dl = a.next_batch(now=0.0)
        assert dl == 1.0
        assert [(r.req_id, r.deadline) for r in batch] == \
            [(1, 1.0), (3, 1.0), (0, 2.0), (2, 2.0)]
        assert b.next_batch(0.0)[0][0].req_id == 0


def test_requeue_keeps_the_tie_break():
    seen = []
    for mod in (tbt, jbt):
        b = mod.DeadlineBatcher(1, max_queue=2)
        first, second = mod.Request(1.0), mod.Request(1.0)
        b.submit(first)
        b.submit(second)
        assert not b.submit(mod.Request(0.5))      # full: overflowed
        got = b.pop_one(0.0)
        b.requeue(got)                             # past max_queue's check
        assert len(b) == 2
        seen.append([b.pop_one(0.0).req_id, b.pop_one(0.0).req_id,
                     [r.deadline for r in b.overflowed]])
    assert seen[0] == seen[1] == [0, 1, [0.5]]


def test_requeue_of_a_request_never_admitted_raises():
    messages = []
    for mod in (tbt, jbt):
        b = mod.DeadlineBatcher(2)
        with pytest.raises(ValueError) as err:
            b.requeue(mod.Request(deadline=1.0))
        messages.append(str(err.value))
        assert b.next_batch(0.0) is None and b.pop_one(0.0) is None
    assert messages[0] == messages[1]
