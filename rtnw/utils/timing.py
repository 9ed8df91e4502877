"""Render timing.

Replaces GPUTimer's cudaEvent pairs (GPUTimer.h:12-35) and the host Clock
(CUDAPathTracer.h:65-70). On JAX the subtlety is asynchronous dispatch: a
call returns before the device finishes, so every timer waits with
`block_until_ready` before reading the clock.
"""

from __future__ import annotations

import time
from contextlib import contextmanager

import jax


def sync(tree) -> None:
    """Wait until every array of `tree` is computed."""
    jax.block_until_ready(tree)


class Timer:
    """Wall-clock timer with device sync on stop (GPUTimer analogue)."""

    def __init__(self) -> None:
        self._start = 0.0
        self.elapsed_ms = 0.0

    def start(self) -> "Timer":
        self._start = time.perf_counter()
        return self

    def stop(self, result=None) -> float:
        if result is not None:
            sync(result)
        self.elapsed_ms = (time.perf_counter() - self._start) * 1e3
        return self.elapsed_ms


@contextmanager
def timed(label: str, result_fn=None, printer=print):
    """Context manager printing '<label>: N ms' like the reference's
    GPUTimer usage around the offline render (main.cu:944-946)."""
    t = Timer().start()
    box = {}
    try:
        yield box
    finally:
        ms = t.stop(box.get("result") if box else None)
        printer(f"{label}: {ms:.3f} ms")


def throughput(paths: int, ms: float) -> float:
    """Paths (camera rays) per second from a timing."""
    return paths / (ms / 1e3) if ms > 0 else float("inf")
