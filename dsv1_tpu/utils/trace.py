"""Profiling hooks (SURVEY.md §5 tracing/profiling).

The reference has no profiler; its closest analogs are the `-v`
per-frame progress + bitrate report (dsv_main.c:516-551) and per-plane
size logging (hzcc.c:475), which the CLI mirrors. For real performance
work this module adds the device tool: JAX profiler traces viewable
in TensorBoard/Perfetto (device kernels, host dispatch, transfers), and
a lightweight stage timer for frames/s accounting.
"""

import contextlib
import time

from . import log


@contextlib.contextmanager
def profile_trace(trace_dir: str):
    """Capture a JAX profiler trace (device + host) into trace_dir.

    View with TensorBoard's profile plugin or ui.perfetto.dev. CLI:
    `-prof_<dir>` wraps the whole encode/decode in one trace.
    """
    import jax
    jax.profiler.start_trace(trace_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
        log.info(f"profiler trace written to {trace_dir}")


class StageTimer:
    """Per-stage wall-clock accounting with frames/s summary lines."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str, n_items: int = 0):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + n_items

    def report(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items(),
                                  key=lambda kv: -kv[1]):
            n = self.counts.get(name, 0)
            rate = f" ({n / total:.1f}/s)" if n and total > 0 else ""
            lines.append(f"{name}: {total * 1e3:.1f} ms{rate}")
        return "\n".join(lines)
