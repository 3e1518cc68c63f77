"""The measured window: one client, one job at a time, back to back.

A job is a list of phases (`prove`, then `verify` where the traffic
asks for it), each timed on the host clock from its call to the end of
a device synchronize.  A job starts only while the clock is before the
deadline; the job in flight at the deadline finishes and counts.  A
phase's metric is all of its time in the window over the jobs that ran
it.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence


@dataclass
class Job:
    index: int
    start: float
    seconds: Dict[str, float] = field(default_factory=dict)
    error: Optional[str] = None
    output: object = None


@dataclass
class Window:
    start: float
    end: float
    jobs: List[Job]

    def per_job(self, phase: str) -> Optional[float]:
        """All of `phase`'s time over the jobs that completed it."""
        done = [j.seconds[phase] for j in self.jobs if phase in j.seconds]
        return sum(done) / len(done) if done else None

    @property
    def failed(self) -> int:
        return sum(1 for j in self.jobs if j.error is not None)


def run_job(index: int, phases: Sequence[str],
            call: Callable[[str, int, object], object],
            sync: Callable[[], None],
            clock: Callable[[], float] = time.perf_counter) -> Job:
    """Run one job's phases in order; each phase gets the previous one's
    output.  An exception ends the job and is recorded."""
    job = Job(index, clock())
    out = None
    for phase in phases:
        t0 = clock()
        try:
            out = call(phase, index, out)
            sync()
        except Exception as e:  # a failed job is counted, not fatal
            job.error = f"{phase}: {type(e).__name__}: {e}"
            return job
        job.seconds[phase] = clock() - t0
        if phase == phases[0]:
            job.output = out
    return job


def run_window(seconds: float, first_index: int, phases: Sequence[str],
               call: Callable[[str, int, object], object],
               sync: Callable[[], None],
               clock: Callable[[], float] = time.perf_counter) -> Window:
    start = clock()
    deadline = start + seconds
    jobs: List[Job] = []
    k = first_index
    while clock() < deadline:
        jobs.append(run_job(k, phases, call, sync, clock))
        k += 1
    return Window(start, clock(), jobs)
