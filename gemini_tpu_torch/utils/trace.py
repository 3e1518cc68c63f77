"""Tracing and memory profiling (the `print-trace` feature +
examples/snark.rs:17-41 memory watcher, SURVEY.md §5).

Enable span printing with GEMINI_TPU_TRACE=1 (the analogue of
building the reference with `--features print-trace`).  `SpanTotals`
sums the spans that end while it is active, by label, with or without
printing.
"""

from __future__ import annotations

import os
import threading
import time


def _enabled() -> bool:
    return os.environ.get("GEMINI_TPU_TRACE") == "1"


_depth = 0
_totals: list = []  # the active SpanTotals


def start_timer(label: str):
    """Returns a span token for end_timer (ark-std start_timer!)."""
    global _depth
    if _enabled():
        print(f"{'··' * _depth}Start: {label}", flush=True)
        _depth += 1
    return (label, time.time())


def end_timer(span) -> float:
    global _depth
    label, t0 = span
    dt = time.time() - t0
    for totals in _totals:
        totals.add(label, dt)
    if _enabled():
        _depth = max(0, _depth - 1)
        print(f"{'··' * _depth}End: {label} "
              f"{dt * 1000:.3f}ms", flush=True)
    return dt


class SpanTotals:
    """`with SpanTotals() as spans:` sums the spans ending inside the
    block: `spans.ms[label]` (host clock) and `spans.count[label]`."""

    def __init__(self):
        self.ms: dict = {}
        self.count: dict = {}

    def add(self, label: str, dt: float) -> None:
        self.ms[label] = self.ms.get(label, 0.0) + dt * 1e3
        self.count[label] = self.count.get(label, 0) + 1

    def __enter__(self):
        _totals.append(self)
        return self

    def __exit__(self, *exc):
        _totals.remove(self)


class MemoryWatcher:
    """Background thread logging RSS growth (examples/snark.rs:17-41:
    procinfo statm polled every `interval` seconds, logged when growth
    exceeds `threshold_kib`)."""

    def __init__(self, interval: float = 10.0, threshold_kib: int = 10):
        self.interval = interval
        self.threshold = threshold_kib * 1024
        self._stop = threading.Event()
        self._thread = None
        self.peak = 0

    @staticmethod
    def _rss() -> int:
        try:
            with open("/proc/self/statm") as f:
                return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
        except Exception:
            return 0

    def _run(self):
        last = 0
        while not self._stop.wait(self.interval):
            rss = self._rss()
            self.peak = max(self.peak, rss)
            if abs(rss - last) > self.threshold:
                print(f"[mem] rss = {rss / 2**20:.1f} MiB", flush=True)
                last = rss

    def __enter__(self):
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=1.0)
        self.peak = max(self.peak, self._rss())
