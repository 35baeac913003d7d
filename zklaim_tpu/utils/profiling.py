"""Per-phase timing + optional XLA profiler traces.

The reference's observability is libsnark/libff's profiling prints,
which it normally suppresses and re-enables with a DEBUG define
(zklaim/libsnark_wrapper.cpp:196-203,21; SURVEY.md §5 "Tracing").
Equivalent here: explicit phase timers with the benchmark CSV's
phase names (issuer/prover/verifier, main_benchmark.c:150-164) plus
hooks into jax.profiler for device traces.

Enable with ZKLAIM_PROFILE=1 (stderr timing lines) and
ZKLAIM_TRACE_DIR=/path (XLA profiler traces viewable in xprof /
tensorboard).
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from dataclasses import dataclass, field


def _enabled() -> bool:
    return os.environ.get("ZKLAIM_PROFILE", "") not in ("", "0")


@dataclass
class PhaseTimer:
    """Accumulates wall-clock per named phase; thread-unsafe by design
    (one per pipeline, like the reference's per-worker clocks)."""

    times_ms: dict = field(default_factory=dict)
    counts: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = (time.perf_counter() - t0) * 1e3
            self.times_ms[name] = self.times_ms.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1
            if _enabled():
                print(f"[zklaim-profile] {name}: {dt:.1f} ms", file=sys.stderr)

    def csv_row(self, num_payloads: int, sizes: tuple) -> str:
        """Reference benchmark CSV row (main_benchmark.c:163 schema)."""
        pk_b, vk_b, proof_b = sizes
        return (
            f"{int(time.time())},{num_payloads},"
            f"{self.times_ms.get('issuer', 0):.1f},"
            f"{self.times_ms.get('prover', 0):.1f},"
            f"{self.times_ms.get('verifier', 0):.1f},"
            f"{pk_b},{vk_b},{proof_b}"
        )


@contextlib.contextmanager
def device_trace(label: str = "zklaim"):
    """XLA profiler trace around a region when ZKLAIM_TRACE_DIR is set."""
    trace_dir = os.environ.get("ZKLAIM_TRACE_DIR", "")
    if not trace_dir:
        yield
        return
    import jax

    with jax.profiler.trace(os.path.join(trace_dir, label)):
        yield


@contextlib.contextmanager
def annotate(name: str):
    """Named region visible in device traces (TraceAnnotation)."""
    import jax

    with jax.profiler.TraceAnnotation(name):
        yield
