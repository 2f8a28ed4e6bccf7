"""Per-stage timing/tracing — first-class observability the reference lacked
(SURVEY.md §5: bare prints only). Wraps stages in context managers and can
emit a JAX profiler trace for device work.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict


class StageTimer:
    def __init__(self, enabled: bool = True, sync_jax: bool = False):
        self.enabled = enabled
        self.sync_jax = sync_jax
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.sync_jax:
                import jax

                jax.effects_barrier()
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for k in self.totals:
            lines.append(
                f"{k:>16s}: {self.totals[k]*1e3:9.2f} ms  x{self.counts[k]}"
            )
        return "\n".join(lines)


def stage_timer(enabled: bool = True, sync_jax: bool = False) -> StageTimer:
    return StageTimer(enabled=enabled, sync_jax=sync_jax)


@contextlib.contextmanager
def jax_profile_trace(logdir: str):
    """Capture a JAX profiler trace (view with tensorboard/xprof)."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class CompileLog:
    """Per-program XLA compile-time attribution (captured, not estimated).

    Parses jax's ``jax_log_compiles`` messages ("Finished XLA compilation of
    jit(foo) in 1.23 sec") into ``entries``, which makes cold-start cost
    visible program by program."""

    def __init__(self):
        self.entries: list[tuple[str, float]] = []

    def total(self) -> float:
        return sum(s for _, s in self.entries)

    def top(self, n: int = 8) -> list[tuple[str, float]]:
        merged: dict[str, float] = defaultdict(float)
        for name, sec in self.entries:
            merged[name] += sec
        return sorted(merged.items(), key=lambda kv: -kv[1])[:n]

    def report(self) -> str:
        t = self.top()
        body = ", ".join(f"{name} {sec:.2f}s" for name, sec in t)
        return (f"{self.total():.1f}s XLA compile across "
                f"{len(self.entries)} programs ({body})")


@contextlib.contextmanager
def compile_log_capture():
    """Capture per-program XLA compile durations inside the block."""
    import logging
    import re

    import jax

    cap = CompileLog()
    pat = re.compile(r"Finished XLA compilation of (.+) in ([0-9.eE+-]+) sec")

    class _H(logging.Handler):
        def emit(self, record):
            m = pat.search(record.getMessage())
            if m:
                cap.entries.append((m.group(1), float(m.group(2))))

    # with jax_log_compiles=True the "Finished XLA compilation" lines are
    # emitted at WARNING, so no level fiddling is needed; jax's own stderr
    # StreamHandler on the "jax" logger is parked during capture so the raw
    # lines don't spam stderr
    handler = _H()
    logger = logging.getLogger("jax")
    prev = jax.config.jax_log_compiles
    prev_handlers = logger.handlers[:]
    prev_propagate = logger.propagate
    jax.config.update("jax_log_compiles", True)
    logger.handlers = [handler]
    logger.propagate = False
    try:
        yield cap
    finally:
        jax.config.update("jax_log_compiles", prev)
        logger.handlers = prev_handlers
        logger.propagate = prev_propagate
