"""Wall-clock timing and running averages.

Mirrors the reference's `utils.Timer`/`Averager` (`/root/reference/utils.py:14-37`)
with an added `block_until_ready`-aware device timer.
"""

from __future__ import annotations

import time


class Averager:
    def __init__(self):
        self.n = 0.0
        self.v = 0.0

    def add(self, v, n=1.0):
        self.v = (self.v * self.n + v * n) / (self.n + n)
        self.n += n

    def item(self):
        return self.v


class Timer:
    def __init__(self):
        self.v = time.time()

    def s(self):
        self.v = time.time()

    def t(self):
        return time.time() - self.v


def time_jitted(fn, *args, warmup: int = 2, iters: int = 10):
    """Time a jitted function with proper device synchronisation.

    Returns seconds/call (median of `iters`).
    """
    import jax

    for _ in range(warmup):
        out = fn(*args)
        jax.block_until_ready(out)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn(*args)
        jax.block_until_ready(out)
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]
