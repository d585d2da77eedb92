"""Structured per-frame observability.

The reference's only runtime metrics are printf during scene load and a
frame counter in the window title (SURVEY.md §5). Here: a FrameStats
record per frame (ms, rays/s, SVGF history-rejection rate, mean variance,
accumulated frame index) plus an optional jax.profiler trace context for
deep dives.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from typing import Optional


@dataclasses.dataclass
class FrameStats:
    frame: int
    ms: float
    rays_per_s: float
    accum_frame: int
    history_rejection_rate: Optional[float] = None
    mean_variance: Optional[float] = None

    def json(self) -> str:
        return json.dumps({k: v for k, v in dataclasses.asdict(self).items()
                           if v is not None})


class StatsCollector:
    """Wraps a Renderer; collects per-frame stats (device syncs per frame,
    so don't use while benchmarking throughput)."""

    def __init__(self, renderer, collect_denoiser_stats: bool = False):
        self.r = renderer
        self.collect_denoiser = collect_denoiser_stats
        self.frames = []

    def render_frame(self):
        import jax
        import numpy as np

        t0 = time.perf_counter()
        left, right = self.r.render_frame()
        jax.block_until_ready(right)
        dt = time.perf_counter() - t0
        w, h = self.r.resolution
        st = FrameStats(frame=len(self.frames), ms=dt * 1000,
                        rays_per_s=w * h / dt,
                        accum_frame=self.r.frame - 1)
        if self.collect_denoiser and "history_length" in self.r.state:
            hist = np.asarray(self.r.state["history_length"])
            st.history_rejection_rate = float((hist <= 1).mean())
            mom = np.asarray(self.r.state["moment_history"])
            st.mean_variance = float(
                np.maximum(mom[..., 1] - mom[..., 0] ** 2, 0).mean())
        self.frames.append(st)
        return left, right


@contextlib.contextmanager
def profiler_trace(logdir: str):
    """jax.profiler trace context (device timeline in TensorBoard format)."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
