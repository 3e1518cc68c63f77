"""What the traced run reads: the program's spans (with their host
intervals), its kernel counters, and the device side of a
`torch.profiler` trace of one prove.

The device arithmetic is adapted from the repository's `chip_smoke.py`
`device_profile` (the busy time is the union of the device intervals,
the port's kernels are known by their demangled names) and extended:
the trace is aligned to the host clock by a marker kernel launched on an
idle device, so that each idle gap can be named by the innermost span
the host was in at its middle.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

Interval = Tuple[str, float, float]  # label, start, end (time.time())


def span_log_class():
    """A `SpanTotals` of the program's `utils/trace` that also keeps each
    span's host interval (built on first use: the program is imported
    only by a run)."""
    from gemini_tpu_torch.utils.trace import SpanTotals

    class SpanLog(SpanTotals):
        def __init__(self):
            super().__init__()
            self.intervals: List[Interval] = []

        def add(self, label: str, dt: float) -> None:
            super().add(label, dt)
            now = time.time()
            self.intervals.append((label, now - dt, now))

    return SpanLog


def counters() -> Dict[str, Dict[str, int]]:
    """The program's exact kernel counters: launches and lanes by kernel,
    for the group-law, MSM-glue and Fr libraries."""
    from gemini_tpu_torch.curve import g1_kernels
    from gemini_tpu_torch.fields import fr_kernels
    from gemini_tpu_torch.ops import msm_kernels

    out = {}
    for lib, mod in (("g1", g1_kernels), ("msm", msm_kernels), ("fr", fr_kernels)):
        out[f"{lib}.launches"] = dict(mod.LAUNCHES)
        out[f"{lib}.lanes"] = dict(mod.LANES)
    return out


def counter_delta(before: dict, after: dict) -> dict:
    return {group: {k: after[group][k] - before[group].get(k, 0) for k in after[group]}
            for group in after}


def short_name(name: str) -> str:
    """The port's kernels by their function name, others by a prefix of
    theirs."""
    _, sep, tail = name.partition("(anonymous namespace)::")
    if sep:
        return tail.split("(")[0].split("<")[0]
    return name[:96]


def own_library(kernel: str) -> Optional[str]:
    """The port's library a kernel function belongs to: `g1` for the
    group-law kernels (C entries g1_*), `msm` for the MSM glue, `fr`
    for the Fr core."""
    if kernel in ("padd_kernel", "padd01_kernel", "mont_mul_kernel",
                  "add_kernel", "dbl_kernel") or kernel.startswith("g1_"):
        return "g1"
    for lib in ("msm", "fr"):
        if kernel.startswith(lib + "_"):
            return lib
    return None


@dataclass
class DeviceTrace:
    window_s: float
    busy_s: float
    events: int
    kernel_s: Dict[str, float] = field(default_factory=dict)
    gaps: List[Tuple[str, float]] = field(default_factory=list)

    def library_s(self, lib: str) -> float:
        return sum(s for k, s in self.kernel_s.items() if own_library(k) == lib)


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def innermost(spans: List[Interval], t: float) -> str:
    best = None
    for label, s, e in spans:
        if s <= t <= e and (best is None or e - s < best[2] - best[1]):
            best = (label, s, e)
    return best[0] if best else "outside any span"


def read_events(events, t0: float, t1: float, offset: float,
                spans: List[Interval]) -> Optional[DeviceTrace]:
    """events: (name, start_us, end_us) device events in the profiler's
    time base; offset: seconds to add to a profiler time (in s) to get
    the host's time.time(); [t0, t1]: the traced window on the host
    clock.  None when no device event falls in the window."""
    inside = []
    for name, s_us, e_us in events:
        s, e = s_us * 1e-6 + offset, e_us * 1e-6 + offset
        if e > t0 and s < t1 and e > s:
            inside.append((name, max(s, t0), min(e, t1)))
    if not inside:
        return None
    kernel_s: Dict[str, float] = {}
    for name, s, e in inside:
        k = short_name(name)
        kernel_s[k] = kernel_s.get(k, 0.0) + (e - s)
    busy = _merge([(s, e) for _, s, e in inside])
    gaps, prev = [], t0
    for s, e in busy + [[t1, t1]]:
        if s > prev:
            gaps.append((innermost(spans, (prev + s) / 2), s - prev))
        prev = max(prev, e)
    return DeviceTrace(window_s=t1 - t0, busy_s=sum(e - s for s, e in busy),
                       events=len(inside), kernel_s=kernel_s, gaps=gaps)


def profile(run, spans_of) -> Optional[DeviceTrace]:
    """Run `run()` (it ends in a device synchronize) under torch.profiler
    (CUDA activity) and read its device side.  A fill kernel on the idle
    device first marks the host time of the trace's clock.  `spans_of()`
    gives the host intervals of the spans of the run, after it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as _profile

    with _profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t_mark = time.time()
        torch.full((1,), 1.5, device="cuda")
        torch.cuda.synchronize()
        t0 = time.time()
        run()
        t1 = time.time()
    dev = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
           if e.device_type == DeviceType.CUDA]
    if not dev:
        return None
    marks = [ev for ev in dev if "Fill" in ev[0]] or dev
    first = min(marks, key=lambda ev: ev[1])
    offset = t_mark - first[1] * 1e-6
    return read_events([ev for ev in dev if ev is not first], t0, t1, offset,
                       spans_of())


def breakdown(dt: DeviceTrace) -> dict:
    ops = sorted(dt.kernel_s.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(dt.gaps, key=lambda g: -g[1])[:10]
    return {"device_ops": [[k, s] for k, s in ops],
            "idle_gaps": [[label, s] for label, s in gaps]}


@dataclass
class Trace:
    """What a per-layer reader reads.  `jobs`, `phase_s`, `spans_ms` and
    `counts` cover the span window (every job after the
    profiled one); `device` and `profiled_lanes` cover the profiled
    prove (`profiled_jobs` of them)."""

    jobs: int
    phase_s: Dict[str, float]
    spans_ms: Dict[str, float]
    counts: Dict[str, Dict[str, int]]
    device: Optional[DeviceTrace]
    profiled_jobs: int
    profiled_lanes: Dict[str, Dict[str, int]]

    def span_per_job(self, *labels: str) -> Optional[float]:
        if not self.jobs or not any(lab in self.spans_ms for lab in labels):
            return None
        return sum(self.spans_ms.get(lab, 0.0) for lab in labels) / self.jobs
