"""Profiling & metrics — the observability subsystem the reference lacked
(SURVEY.md §5: the reference has only log lines; no timers, no counters).

- `trace(dir)`: context manager around jax.profiler for device timelines
  (view with TensorBoard / xprof; tools_dev/trace_flagship.py reduces one
  to busy/idle share and top ops).
- `BatchMetrics`: per-batch counters (rays, seconds, Mrays/s, spp/s) with a
  JSONL sink, cheap enough to leave on.
"""

from __future__ import annotations

import contextlib
import json
import logging
from dataclasses import dataclass, field
from typing import List, Optional

log = logging.getLogger(__name__)


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a jax.profiler trace of the enclosed block into `log_dir`.
    A trace that was asked for and cannot start raises."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
        log.info("profile written to %s", log_dir)


@dataclass
class BatchRecord:
    batch: int
    seconds: float
    rays: float
    pixels: int
    spp: int

    @property
    def mrays_per_sec(self) -> float:
        return self.rays / self.seconds / 1e6 if self.seconds > 0 else 0.0

    @property
    def spp_per_sec(self) -> float:
        return self.spp / self.seconds if self.seconds > 0 else 0.0


@dataclass
class BatchMetrics:
    """Per-batch render metrics with optional JSONL persistence."""

    pixels: int
    spp: int
    jsonl_path: Optional[str] = None
    records: List[BatchRecord] = field(default_factory=list)

    def record(self, batch: int, seconds: float, rays: float) -> BatchRecord:
        rec = BatchRecord(batch=batch, seconds=seconds, rays=rays,
                          pixels=self.pixels, spp=self.spp)
        self.records.append(rec)
        log.debug(
            "batch %d: %.3fs, %.2fM rays, %.1f Mrays/s, %.2f spp/s",
            batch, seconds, rays / 1e6, rec.mrays_per_sec, rec.spp_per_sec,
        )
        if self.jsonl_path:
            with open(self.jsonl_path, "a") as f:
                f.write(json.dumps({
                    "batch": batch, "seconds": seconds, "rays": rays,
                    "mrays_per_sec": rec.mrays_per_sec,
                    "spp_per_sec": rec.spp_per_sec,
                }) + "\n")
        return rec

    @property
    def total_rays(self) -> float:
        return sum(r.rays for r in self.records)

    @property
    def total_seconds(self) -> float:
        return sum(r.seconds for r in self.records)

    @property
    def mrays_per_sec(self) -> float:
        t = self.total_seconds
        return self.total_rays / t / 1e6 if t > 0 else 0.0
