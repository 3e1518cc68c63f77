"""The two timers of the port's benchmarks and of chip_smoke.py.

  event_ms  device milliseconds per call, from CUDA events around a run
            of calls queued behind a spin kernel;
  wall_s    best host-clock seconds of a few calls, after a first
            (warm-up) call.
"""

from __future__ import annotations

import time

import torch

SPIN_CYCLES = 4_000_000  # about 2 ms of spin kernel at the H100's clock


def event_ms(fn, iters: int, warm: bool = True, device=None,
             spin_cycles: int = SPIN_CYCLES) -> float:
    """Device ms per call of `fn` (which launches work on the current
    stream): events around `iters` calls queued behind a spin kernel of
    `spin_cycles`, so a short kernel is timed by the card and not at the
    host's launch rate as long as the host queues the calls within the
    spin.  With `warm`, one untimed call comes first."""
    if warm:
        fn()
    torch.cuda.synchronize(device)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(spin_cycles)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize(device)
    return e0.elapsed_time(e1) / iters


def wall_s(fn, rounds: int = 3) -> tuple[float, float]:
    """(best seconds of `rounds` calls, seconds of the first call before
    them).  `fn` must end in a synchronize when it runs on a card."""
    t0 = time.time()
    fn()
    first = time.time() - t0
    best = float("inf")
    for _ in range(rounds):
        t0 = time.time()
        fn()
        best = min(best, time.time() - t0)
    return best, first
