"""Deadline-aware request batching (port of ``repro.serving.batcher``).

Requests carry absolute deadlines; the batcher forms fixed-size batches in
earliest-deadline-first order and reports the batch's effective deadline
(its tightest member's), which is what the ALERT controller schedules
against.  Requests that can no longer make ``min_feasible_latency`` are
failed fast at pop time, and an optional bounded queue sheds load at
submit time (backpressure).

Ids are per batcher: each batcher numbers its requests from its own
counter, so two batchers, or two runs, see the same id sequences, and EDF
ties break by submission order within the batcher.  Host-side Python,
no tensors.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Any


@dataclasses.dataclass(order=False)
class Request:
    """One inference request: an absolute ``deadline``, an opaque
    ``payload``, and a ``req_id`` the batcher assigns at submit time
    unless the caller set one."""

    deadline: float                # absolute time (s)
    payload: Any = None
    arrival: float = 0.0
    req_id: int | None = None
    # Heap sequence assigned at first admission; requeue() reuses it, so
    # a deferred request keeps its submission-order tie-break.
    _seq: int | None = dataclasses.field(
        default=None, repr=False, compare=False)


class DeadlineBatcher:
    """Earliest-deadline-first batch former with fail-fast admission.

    Requests whose deadline can no longer be met (given
    ``min_feasible_latency``) are rejected at pop time into ``rejected``.
    ``max_queue`` bounds the queue: submissions beyond it are refused and
    recorded in ``overflowed``.  ``metrics`` is any object with
    ``.counter(name).inc()``; the batcher counts its admission edges
    there and behaves the same without it.
    """

    def __init__(self, batch_size: int, min_feasible_latency: float = 0.0,
                 max_queue: int | None = None, metrics=None):
        self.batch_size = batch_size
        self.min_feasible_latency = min_feasible_latency
        self.max_queue = max_queue
        self._counter = itertools.count()
        self._heap: list[tuple[float, int, Request]] = []
        self.rejected: list[Request] = []
        self.overflowed: list[Request] = []
        self._m_sub = self._m_ovf = self._m_rej = self._m_req = None
        if metrics is not None:
            self._m_sub = metrics.counter("queue_submitted")
            self._m_ovf = metrics.counter("queue_overflowed")
            self._m_rej = metrics.counter("queue_failfast_rejected")
            self._m_req = metrics.counter("queue_requeued")

    def submit(self, req: Request) -> bool:
        """Enqueue one request (keyed on deadline, then submission order)
        and assign ``req.req_id`` when unset.  Returns False, and records
        the request in ``overflowed``, when the queue holds ``max_queue``
        requests; a refused request consumes no id."""
        if self.max_queue is not None and len(self._heap) >= self.max_queue:
            self.overflowed.append(req)
            if self._m_ovf is not None:
                self._m_ovf.inc()
            return False
        if self._m_sub is not None:
            self._m_sub.inc()
        seq = next(self._counter)
        if req.req_id is None:
            req.req_id = seq
        req._seq = seq
        heapq.heappush(self._heap, (req.deadline, seq, req))
        return True

    def requeue(self, req: Request) -> None:
        """Re-enqueue a request :meth:`submit` already admitted (a
        deferral): ``max_queue`` does not apply and the request keeps its
        original sequence number.  Raises for a request never admitted."""
        if req._seq is None:
            raise ValueError(
                "requeue() takes a request previously admitted by "
                "submit(); this one has no heap seq")
        if self._m_req is not None:
            self._m_req.inc()
        heapq.heappush(self._heap, (req.deadline, req._seq, req))

    def __len__(self) -> int:
        return len(self._heap)

    def pop_one(self, now: float) -> Request | None:
        """Pop the earliest-deadline feasible request; the infeasible ones
        it passes over land in ``rejected``.  None when the queue is
        empty."""
        while self._heap:
            _, _, req = heapq.heappop(self._heap)
            if req.deadline - now < self.min_feasible_latency:
                self.rejected.append(req)
                if self._m_rej is not None:
                    self._m_rej.inc()
                continue
            return req
        return None

    def next_batch(self, now: float) -> tuple[list[Request], float] | None:
        """Pop up to ``batch_size`` feasible requests in EDF order.
        Returns (batch, batch deadline), or None when nothing is left."""
        batch: list[Request] = []
        while len(batch) < self.batch_size:
            req = self.pop_one(now)
            if req is None:
                break
            batch.append(req)
        if not batch:
            return None
        return batch, min(r.deadline for r in batch)
