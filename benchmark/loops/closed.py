"""closed: a closed loop with one client over a pool of batches.

A request is one batch of the pool (cycled in order), timed from its
submission until its values are ready on the card; the next is sent when
it returns.  Each request also copies its answers at the sampled rows
(:mod:`benchmark.check`) into a buffer, one small gather inside its span.
"""

from __future__ import annotations

import math
import time

import torch

from benchmark import trace as trace_mod

# Requests the sample buffer holds, per second of window and per request
# that the warm-up timed: twice what the warm-up's pace predicts.
CAPACITY_FACTOR = 2.0
# Seconds of a traced run's window that the profiler records (at most half
# of it): device metrics come from them, host-clock metrics from the rest,
# which runs without the profiler's overhead.
TRACE_S = 5.0


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Loop:
    """The closed loop, with its sample buffer."""

    def __init__(self, traffic: dict, pool, rows, device):
        if traffic.get("clients", 1) != 1:
            raise SystemExit("benchmark: the closed loop has one client")
        self.pool, self.rows, self.device = pool, rows, device
        self.latency = []
        self.slots = []
        self.profiling = False
        self.untraced_from = 0

    def warm(self, request) -> float:
        """Run every pool batch once (builds, caches, first use); the
        fastest request's seconds."""
        best = math.inf
        self.stored = torch.empty(1, self.rows.shape[1], dtype=self.pool.dtype,
                                  device=self.device)
        for slot in range(self.pool.shape[0]):
            t0 = time.perf_counter()
            request(self.pool[slot], self.rows[slot], self.stored[0])
            _sync(self.device)
            best = min(best, time.perf_counter() - t0)
        return best

    def run(self, request, seconds: float, per_request_s: float, prof=None) -> float:
        """Requests until ``seconds`` have passed; returns the window's
        seconds.

        ``request(batch, rows, out)`` answers ``batch`` and writes its
        answers at ``rows`` into ``out``.  With ``prof`` (a started
        profiler) the first ``TRACE_S`` seconds are traced, inside a span
        named ``trace.WINDOW_SPAN``, and the profiler stops; requests from
        ``self.untraced_from`` on ran without it.
        """
        cap = max(64, int(CAPACITY_FACTOR * seconds / max(per_request_s, 1e-6)) + 64)
        self.stored = torch.empty(cap, self.rows.shape[1], dtype=self.pool.dtype,
                                  device=self.device)
        self.cap = cap
        P = self.pool.shape[0]
        traced_s = min(TRACE_S, seconds / 2)
        span = None
        if prof is not None:
            span = torch.profiler.record_function(trace_mod.WINDOW_SPAN)
            span.__enter__()
        self.profiling = span is not None

        def stop_tracing(j):
            span.__exit__(None, None, None)
            prof.stop()
            self.profiling = False
            self.untraced_from = j

        self.untraced_from = 0
        j = 0
        t_start = time.perf_counter()
        while True:
            elapsed = time.perf_counter() - t_start
            if self.profiling and elapsed >= traced_s:
                stop_tracing(j)
            if elapsed >= seconds:
                break
            slot = j % P
            t0 = time.perf_counter()
            request(self.pool[slot], self.rows[slot], self.stored[j % cap])
            _sync(self.device)
            self.latency.append(time.perf_counter() - t0)
            self.slots.append(slot)
            j += 1
        t_end = time.perf_counter()
        if self.profiling:
            stop_tracing(j)
        self.t_start = t_start
        return t_end - t_start

    def untraced(self, values: list) -> list:
        """The part of a per-request list that ran without the profiler."""
        return values[self.untraced_from:]

    def judged(self):
        """(stored answers, their pool slots) of the requests the buffer
        still holds."""
        n = len(self.slots)
        if n <= self.cap:
            return self.stored[:n], self.slots
        # The buffer wrapped: it holds the last ``cap`` requests.
        rows = [r % self.cap for r in range(n - self.cap, n)]
        return self.stored[rows], [self.slots[r] for r in range(n - self.cap, n)]

    def sampled_queries(self) -> torch.Tensor:
        """[pool, S, dim] the queries at the sampled rows."""
        return torch.stack([self.pool[s][self.rows[s]] for s in range(self.pool.shape[0])])
