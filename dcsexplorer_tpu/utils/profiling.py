"""Profiling/observability helpers.

The reference has no profiling beyond wall-clock timers (SURVEY.md §5).
Here:
- ``stage_timer``: named wall-clock stage accounting with a report table
- ``device_trace``: context manager around ``jax.profiler.trace`` producing
  an xprof/perfetto trace directory for the device pipeline
"""

import contextlib
import time
from collections import defaultdict


class StageTimer:
    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self):
        lines = ["stage                          total_ms   calls"]
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            lines.append(f"{name:<30} {self.totals[name]*1000:9.1f} "
                         f"{self.counts[name]:7d}")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir="build/jax_trace"):
    """Capture a JAX profiler trace (view with xprof/perfetto)."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()

