"""Micro-batching scheduler: coalesce small requests into device batches
(port of lightgbm_tpu/serving/batcher.py).

Single-row traffic is the worst case for a device predictor — each
flush pays a host->device copy, the walk's launches and a device->host
copy for one row. The
batcher amortizes that: concurrent requests queue up and a background
worker flushes them as one padded batch when either (a) `max_batch` rows
have accumulated or (b) the oldest request has waited `max_delay_ms`.

Operational guarantees:

* Admission control — a full queue (`max_queue_rows`) fast-fails new
  requests with OverloadedError instead of building unbounded latency.
  With a `serving.shed.LoadShedder` attached, admission is priority-
  aware: each request carries a class (pinned / versioned / shadow)
  and the shedder's headroom fractions + brownout level decide who is
  rejected first (shadow, then versioned, pinned last).
* Per-request timeout — requests that exceed their deadline while queued
  are failed at flush time, and waiters give up on their own clock.
* Version consistency — the model version is resolved ONCE per request
  (before any splitting) and once per flush group, so every row of a
  response comes from a single model even while a hot swap lands
  mid-flight; the version used is returned with the result.
* Oversize requests — inputs larger than `max_batch` are split into
  batch-sized chunks pinned to one resolved version and reassembled.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import List, Optional, Tuple

import numpy as np

from ..resilience import faults
from ..telemetry import spans as telem_spans
from ..utils import log
from .stats import ServingStats


class OverloadedError(RuntimeError):
    """Queue depth cap hit: shed load instead of queueing."""


class RequestTimeout(TimeoutError):
    """Request exceeded its deadline before a result was produced."""


class _Pending:
    """One queued request; waiters block on `event`."""

    __slots__ = ("x", "n", "version", "raw_score", "t_enqueue", "deadline",
                 "event", "result", "result_version", "error", "trace")

    def __init__(self, x, version, raw_score, timeout_s, trace=None):
        now = time.monotonic()
        self.x = x
        self.n = x.shape[0]
        self.version = version           # concrete version tag
        self.raw_score = raw_score
        self.t_enqueue = now
        self.deadline = now + timeout_s if timeout_s else None
        self.event = threading.Event()
        self.result = None
        self.result_version = None
        self.error = None
        # sampled request timeline (serving.trace.Trace | None): rides
        # the item because the flush worker emits the batcher/predictor
        # spans from its own thread
        self.trace = trace

    def finish(self, result=None, version=None, error=None):
        self.result = result
        self.result_version = version
        self.error = error
        self.event.set()

    def wait(self, timeout_s: Optional[float]):
        if not self.event.wait(timeout_s):
            raise RequestTimeout("request timed out waiting for batch")
        if self.error is not None:
            raise self.error
        return self.result, self.result_version


class MicroBatcher:
    """Request queue + flush worker in front of a PredictorCache.

    `start=False` skips the worker thread: nothing flushes until
    `flush()` is called, which makes batching behavior deterministic for
    tests and embedders with their own event loop.
    """

    def __init__(self, registry, max_batch: int = 256,
                 max_delay_ms: float = 2.0, max_queue_rows: int = 4096,
                 default_timeout_ms: float = 5000.0,
                 stats: Optional[ServingStats] = None, start: bool = True,
                 shed=None):
        self.registry = registry
        # optional serving.shed.LoadShedder: priority-class admission
        # (None keeps the single flat queue cap)
        self.shed = shed
        self.max_batch = int(max_batch)
        self.max_delay_s = float(max_delay_ms) / 1e3
        self.max_queue_rows = int(max_queue_rows)
        self.default_timeout_s = float(default_timeout_ms) / 1e3
        self.stats = stats or ServingStats()
        self._queue: deque = deque()
        self._queued_rows = 0
        self._cv = threading.Condition()
        self._closed = False
        self._draining = False
        self._worker = None
        if start:
            self._worker = threading.Thread(
                target=self._run, name="lgbm-torch-batcher", daemon=True)
            self._worker.start()

    # -- client side ----------------------------------------------------
    def submit(self, rows, version: Optional[str] = None,
               raw_score: bool = False,
               timeout_ms: Optional[float] = None,
               trace=None, priority: str = "pinned") -> Tuple[np.ndarray, str]:
        """Blocking predict through the batch queue. Returns
        (scores (N, num_class), model version used)."""
        handles = self.submit_async(rows, version, raw_score, timeout_ms,
                                    trace=trace, priority=priority)
        timeout_s = (self.default_timeout_s if timeout_ms is None
                     else timeout_ms / 1e3)
        # grace on top of the request deadline: expiry is reported by the
        # flusher; the waiter clock is only a backstop against a dead worker
        parts, ver = [], None
        for h in handles:
            out, ver = h.wait(timeout_s + 1.0)
            parts.append(out)
        return (parts[0] if len(parts) == 1
                else np.concatenate(parts, axis=0)), ver

    def submit_async(self, rows, version: Optional[str] = None,
                     raw_score: bool = False,
                     timeout_ms: Optional[float] = None,
                     trace=None, priority: str = "pinned") -> List[_Pending]:
        """Enqueue without blocking for the result; returns the pending
        handles (one per <=max_batch chunk, in row order)."""
        x = np.ascontiguousarray(np.asarray(rows, dtype=np.float32))
        if x.ndim == 1:
            x = x.reshape(1, -1)
        timeout_s = (self.default_timeout_s if timeout_ms is None
                     else timeout_ms / 1e3)
        # pin the version before splitting: every chunk of one request
        # must be served by the same model even across a hot swap
        concrete = self.registry.get(version).version
        chunks = ([x] if x.shape[0] <= self.max_batch else
                  [x[i:i + self.max_batch]
                   for i in range(0, x.shape[0], self.max_batch)])
        if len(chunks) > 1:
            self.stats.incr("serve_requests_split")
        handles = []
        with self._cv:
            if self._closed:
                raise RuntimeError("batcher is closed")
            if self._draining:
                # graceful shutdown: stop admitting, keep flushing what
                # is already queued (run_http_server drains on exit)
                self.stats.incr("serve_rejected_draining")
                raise OverloadedError("batcher is draining")
            if self.shed is not None:
                # priority-aware admission: brownout level + per-class
                # queue headroom (shadow rejected first, pinned last)
                reason = self.shed.admit(priority, self._queued_rows,
                                         x.shape[0], self.max_queue_rows)
                if reason is not None:
                    self.stats.incr("serve_shed_" + priority)
                    raise OverloadedError(f"shed [{priority}]: {reason}")
            if self._queued_rows + x.shape[0] > self.max_queue_rows:
                self.stats.incr("serve_rejected_overload")
                raise OverloadedError(
                    f"queue full ({self._queued_rows} rows queued, "
                    f"cap {self.max_queue_rows})")
            for chunk in chunks:
                item = _Pending(chunk, concrete, raw_score, timeout_s,
                                trace=trace)
                self._queue.append(item)
                self._queued_rows += chunk.shape[0]
                handles.append(item)
            self.stats.incr("serve_requests")
            self._cv.notify_all()
        return handles

    # -- flush side -----------------------------------------------------
    def flush(self) -> int:
        """Drain and execute one batch group synchronously; returns rows
        flushed (0 on an empty queue — a no-op)."""
        batch = self._pop_batch()
        if not batch:
            return 0
        return self._execute(batch)

    def _pop_batch(self) -> List[_Pending]:
        """Pop a FIFO prefix of compatible requests (same version +
        raw_score) totalling <= max_batch rows."""
        with self._cv:
            if not self._queue:
                return []
            first = self._queue[0]
            group_key = (first.version, first.raw_score)
            batch, rows = [], 0
            while self._queue:
                item = self._queue[0]
                if (item.version, item.raw_score) != group_key:
                    break
                if batch and rows + item.n > self.max_batch:
                    break
                batch.append(self._queue.popleft())
                rows += item.n
            self._queued_rows -= rows
            return batch

    def _execute(self, batch: List[_Pending]) -> int:
        with telem_spans.span("serve_flush", requests=len(batch)):
            return self._execute_inner(batch)

    def _execute_inner(self, batch: List[_Pending]) -> int:
        # fault site: an injected delay here models a stalled device /
        # slow predictor, driving requests past their deadlines so the
        # timeout path below is deterministically testable
        faults.sleep_point("serve_flush")
        now = time.monotonic()
        live: List[_Pending] = []
        for item in batch:
            # queue wait = enqueue -> flush, expired requests included:
            # the tail of this histogram is exactly what admission
            # control and max_delay_ms tuning need to see
            self.stats.observe("serve_queue_wait", now - item.t_enqueue)
            if item.deadline is not None and now > item.deadline:
                self.stats.incr("serve_timeouts")
                item.finish(error=RequestTimeout(
                    "request expired in queue before flush"))
            else:
                live.append(item)
        if not live:
            return 0
        version, raw_score = live[0].version, live[0].raw_score
        x = (live[0].x if len(live) == 1
             else np.concatenate([i.x for i in live], axis=0))
        try:
            t0 = time.monotonic()
            # fault site: fail_request@version= clauses raise here — the
            # injected per-version error spike the canary router demotes on
            faults.request_point(version)
            model = self.registry.get(version)
            out = self.registry.predictor.predict(model, x, raw_score)
            exec_s = time.monotonic() - t0
            self.stats.observe("serve_batch_exec", exec_s)
            self.stats.incr("serve_batches")
            self.stats.incr("serve_rows", x.shape[0])
        except Exception as exc:   # noqa: BLE001 — propagate to waiters
            log.warning("serving: batch of %d rows failed: %s",
                        x.shape[0], exc)
            self.stats.incr("serve_batch_errors")
            for item in live:
                item.finish(error=exc)
            return x.shape[0]
        off = 0
        for item in live:
            if item.trace is not None:
                # batcher span = queue wait; predictor span = this
                # item's share of the device execute (whole-batch time,
                # batch context attached so amortization is visible)
                item.trace.span("batcher", now - item.t_enqueue,
                                rows=item.n, batch_requests=len(live),
                                version=version)
                item.trace.span("predictor", exec_s,
                                rows=item.n, batch_rows=x.shape[0],
                                version=version)
            item.finish(result=out[off:off + item.n], version=version)
            off += item.n
        return x.shape[0]

    # -- worker ---------------------------------------------------------
    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._closed:
                    self._cv.wait()
                if self._closed and not self._queue:
                    return
                first = self._queue[0]
                flush_at = first.t_enqueue + self.max_delay_s
                # linger for more rows until the batch fills or the
                # oldest request's coalescing deadline passes
                while (self._queued_rows < self.max_batch
                       and not self._closed):
                    remaining = flush_at - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cv.wait(timeout=remaining)
            batch = self._pop_batch()
            if batch:
                self._execute(batch)

    # -- liveness / shutdown --------------------------------------------
    def alive(self) -> bool:
        """Liveness for /healthz: open for business and (when a worker
        was started) the worker thread still running. Inline mode
        (start=False) has no worker to die, so open == alive."""
        if self._closed or self._draining:
            return False
        return self._worker is None or self._worker.is_alive()

    @property
    def queued_rows(self) -> int:
        with self._cv:
            return self._queued_rows

    @property
    def draining(self) -> bool:
        return self._draining

    def drain(self, timeout_s: float = 5.0) -> None:
        """Graceful shutdown: stop admitting new requests, flush every
        batch already in the queue (the worker keeps flushing; inline
        mode flushes here), then close. In-flight waiters get real
        results — only requests arriving after the drain started are
        rejected."""
        with self._cv:
            if self._closed:
                return
            self._draining = True
            self._cv.notify_all()
        deadline = time.monotonic() + max(0.0, float(timeout_s))
        while time.monotonic() < deadline:
            if self._worker is None or not self._worker.is_alive():
                # no worker to flush for us: do it inline
                if self.flush() == 0 and self.queued_rows == 0:
                    break
            else:
                if self.queued_rows == 0:
                    break
                time.sleep(0.005)
        self.close()

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        if self._worker is not None:
            self._worker.join(timeout=5.0)
        while True:
            batch = self._pop_batch()
            if not batch:
                break
            for item in batch:
                item.finish(error=RuntimeError("batcher closed"))
