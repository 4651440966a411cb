"""Profiling harness (SURVEY.md §5.1 — absent in the reference).

`trace()` wraps a block in a jax.profiler trace (viewable in TensorBoard /
Perfetto); `Timeline` gives coarse per-section wall times with device
barriers (`jax.block_until_ready`).
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, Iterator

import jax


@contextlib.contextmanager
def trace(logdir: str = "traces/jax-trace") -> Iterator[None]:
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class Timeline:
    """Named wall-clock sections with device barriers."""

    def __init__(self):
        self.sections: Dict[str, float] = {}

    @contextlib.contextmanager
    def section(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        yield
        self.sections[name] = self.sections.get(name, 0.0) + (
            time.perf_counter() - t0
        )

    def barrier(self, value):
        """Wait until `value` is computed on the device."""
        return jax.block_until_ready(value)

    def report(self) -> str:
        total = sum(self.sections.values())
        lines = [f"total {total*1e3:.1f} ms"]
        for k, v in sorted(self.sections.items(), key=lambda kv: -kv[1]):
            lines.append(f"  {k}: {v*1e3:.1f} ms ({100*v/total:.0f}%)")
        return "\n".join(lines)
