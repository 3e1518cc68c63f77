"""The timers of the port's benchmarks and of chip_smoke.py.

  event_ms     device milliseconds per call, from CUDA events around a
               run of calls queued behind a spin kernel; refuses a run in
               which the host was still queueing when the spin ended;
  profiler_ms  device milliseconds per call of the kernels a function
               launches, from torch.profiler's device events (the kernels'
               own durations, without the gaps between them);
  wall_s       best host-clock seconds of a few calls, after a first
               (warm-up) call.
"""

from __future__ import annotations

import time

import torch

SPIN_CYCLES = 4_000_000  # about 2 ms of spin kernel at the H100's clock
SPIN_TRIES = 6  # the spin doubles on each refused run: up to 32x


class QueueingOutlastedSpin(RuntimeError):
    """The host was still queueing the timed calls when the device
    finished the spin, so the events would have timed the host."""


def event_ms(fn, iters: int, warm: bool = True, device=None,
             spin_cycles: int = SPIN_CYCLES) -> float:
    """Device ms per call of `fn` (which launches work on the current
    stream and does not synchronize): events around `iters` calls queued
    behind a spin kernel of `spin_cycles`, so a short kernel is timed by
    the card and not at the host's launch rate.

    The guard: once every call is queued, the event behind the spin must
    still be pending.  If the device has already passed it, it may have
    waited for the host between calls and the time would include host
    time; the spin then doubles and the calls are timed again, up to
    SPIN_TRIES runs, after which QueueingOutlastedSpin is raised.  With
    `warm`, one untimed call comes first."""
    if warm:
        fn()
    for _ in range(SPIN_TRIES):
        torch.cuda.synchronize(device)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin_cycles)
        e0.record()
        for _ in range(iters):
            fn()
        e1.record()
        queued_in_time = not e0.query()
        torch.cuda.synchronize(device)
        if queued_in_time:
            return e0.elapsed_time(e1) / iters
        spin_cycles *= 2
    raise QueueingOutlastedSpin(
        f"event_ms: the host queued {iters} calls more slowly than a spin of "
        f"{spin_cycles // 2} cycles, {SPIN_TRIES} times")


def profiler_ms(fn, iters: int = 20) -> float:
    """Device ms per call of the kernels `fn` launches: the sum of
    torch.profiler's device event durations over `iters` calls, after a
    warm one, over `iters`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
           and e.time_range.end > e.time_range.start]
    if not dev:
        raise RuntimeError("torch.profiler's trace held no device event")
    return sum(e.time_range.end - e.time_range.start for e in dev) / iters / 1e3


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
