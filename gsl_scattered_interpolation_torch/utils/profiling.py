"""Timing and trace capture.

The reference's only instrumentation is the accel hit/miss counters
(gsl_interp.h:41-46).  Here: a wall-clock block timer that waits for the
card before it reads the clock, so timings are honest under PyTorch's
asynchronous launches, a wrapper around ``torch.profiler`` that writes
a Chrome trace, and :func:`span`, which names a stretch of the program on
the profiler's clock while a profiler records.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
import torch.autograd.profiler as _autograd_profiler

# What :func:`span` returns while no profiler records.
_NO_SPAN = contextlib.nullcontext()


def _cuda_devices(obj, out: set) -> set:
    """The CUDA devices of the tensors in ``obj``: a tensor, or nested
    tuples, lists and dicts of them."""
    if isinstance(obj, torch.Tensor):
        if obj.device.type == "cuda":
            out.add(obj.device)
    elif isinstance(obj, (tuple, list)):
        for o in obj:
            _cuda_devices(o, out)
    elif isinstance(obj, dict):
        for o in obj.values():
            _cuda_devices(o, out)
    return out


def synchronize(obj=None) -> None:
    """Wait for the CUDA devices of the tensors in ``obj``; with no
    ``obj``, for every CUDA device this process has used."""
    if obj is None:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        return
    for dev in _cuda_devices(obj, set()):
        torch.cuda.synchronize(dev)


class Timer:
    """Accumulating named wall-clock timer, synchronised with the card."""

    def __init__(self):
        self.times: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    def _add(self, name: str, dt: float) -> None:
        self.times[name] = self.times.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    @contextlib.contextmanager
    def time(self, name: str, result=None):
        """Time the block.  The clock stops once the devices of
        ``result`` (tensors, or containers of them) are done, or, with
        none given, every CUDA device in use; it starts after earlier
        work on them is done."""
        synchronize(result)
        t0 = time.perf_counter()
        yield
        synchronize(result)
        self._add(name, time.perf_counter() - t0)

    def timed(self, name: str, fn, *args, **kw):
        """``fn(*args, **kw)`` timed until the devices of its arguments
        and its result are done; returns the result."""
        synchronize((args, kw))
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        synchronize((args, kw, out))
        self._add(name, time.perf_counter() - t0)
        return out

    def report(self) -> str:
        lines = [
            f"{k}: {self.times[k]:.4f}s / {self.counts[k]}x"
            for k in sorted(self.times)
        ]
        return "\n".join(lines)


def span(name: str):
    """A context manager that records the block as a user annotation named
    ``name`` while a ``torch.profiler`` session records (the benchmark's
    traced runs, :func:`trace`), on the profiler's clock beside the card's
    kernels; spans nest by time on the calling thread.  With no profiler
    recording it costs one bool read: ``record_function`` itself costs
    microseconds per call even then."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN


@contextlib.contextmanager
def trace(logdir: str):
    """Record a ``torch.profiler`` trace of the block (host operations,
    and the card's kernels when CUDA is available) and write it to
    ``logdir/trace.json`` (open it in chrome://tracing or Perfetto)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
