"""Run one cell of the port's benchmark once and print its result.

    python3 proofbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks
for.  Set-up (the key, the traffic's instances, one warm-up job) runs
first; then the window of --seconds, in which jobs run back to back and
none starts after the deadline.  With --trace 0 the result carries the
cell's end-to-end metrics; with --trace 1 its per-layer metrics, from a
first prove under torch.profiler and the program's spans and counters
over the window that follows.  Then the proofs drawn for the check are
worked out again by the configuration's plain reference
(`reference/<reference>.py`), from the inputs that the driver's `inputs`
makes, and compared byte for byte; each number compared is printed
beside its limit, as the last lines of standard error and under
"checks", the last key of the result, which is the last line of
standard output.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from typing import Optional  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from proofbench import correct, devtrace, jaxguard, spec  # noqa: E402
from proofbench.instances import derive  # noqa: E402
from proofbench.window import Job, Window, run_job  # noqa: E402

CACHE = os.path.join(ROOT, ".bench_cache")


@dataclass
class RunRecord:
    """What a metric reader reads (`metrics/`)."""

    window: Window
    setup_s: float
    window_peak_bytes: Optional[int]
    trace: Optional[devtrace.Trace]


def _log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({type(e).__name__})"
    return out.stdout.strip() or f"not read (nvidia-smi rc {out.returncode})"


def _trace_window(drv, phases, loop, seconds, sync, cuda):
    """The profiled first prove (job 0, then its other phases untraced)
    and the span window after it."""
    span_log = devtrace.span_log_class()
    host_spans = []
    held = {}

    def first_prove():
        t = time.time()
        try:
            held["out"] = drv.call(phases[0], 0, None)
            sync()
        except Exception as e:  # a failed job is counted, not fatal
            held["error"] = f"{phases[0]}: {type(e).__name__}: {e}"
        host_spans.append(("bench::" + phases[0], t, time.time()))

    before = devtrace.counters()
    plog = span_log()
    with plog:
        if cuda:
            dtrace = devtrace.profile(first_prove, lambda: plog.intervals + host_spans)
        else:
            first_prove()
            dtrace = None
    profiled_lanes = devtrace.counter_delta(before, devtrace.counters())
    first = Job(0, time.perf_counter(), output=held.get("out"), error=held.get("error"))
    if len(phases) > 1 and first.error is None:  # its other phases, untraced
        rest = run_job(0, phases[1:], lambda ph, k, prev: drv.call(ph, k, held["out"]),
                       sync)
        first.error = rest.error

    wlog = span_log()
    c0 = devtrace.counters()
    with wlog:
        win = loop.run(seconds, 1, phases, drv.call, sync)
    counts = devtrace.counter_delta(c0, devtrace.counters())
    done = [j for j in win.jobs if j.error is None]
    trace = devtrace.Trace(
        jobs=len(done),
        phase_s={ph: sum(j.seconds[ph] for j in done) for ph in phases},
        spans_ms=dict(wlog.ms), counts=counts,
        device=dtrace, profiled_jobs=1, profiled_lanes=profiled_lanes)
    return win, first, trace


def _check(drv, inputs, reference, traffic, jobs, failed: int, seed: int, device: str):
    """A sample of the finished proofs, drawn from the seed, against the
    reference's proofs of `inputs(traffic, seed, k, device)`; the
    verifier's answer to a tampered proof.  Frees the program's state
    (`drv.release`) before the reference runs."""
    import torch

    done = {j.index: j for j in jobs if j.error is None}
    picked = correct.sample(list(done), int(traffic["check_proofs"]),
                            derive(seed, "check"))
    port = {k: (drv.parts(done[k].output), drv.proof_bytes(done[k].output))
            for k in picked}
    verifies = "verify" in traffic["phases"]
    tamper_accepted = 0
    if verifies and picked:
        tamper_accepted = int(not drv.tamper_rejected(done[picked[0]].output, picked[0]))
    for j in jobs:
        j.output = None
    drv.release()
    if device == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    rows = []
    for k in picked:
        ref_parts, ref_bytes = correct.reference_proof(
            reference, *inputs(traffic, seed, k, device))
        port_parts, port_bytes = port[k]
        rows.append(correct.mismatches(port_parts, ref_parts, port_bytes, ref_bytes))
    ref_s = time.perf_counter() - t_ref
    t = correct.tally(rows)
    checks = {"failed_jobs": {"value": failed, "max": 0},
              "checked_proofs": {"value": len(rows), "min": 1},
              "commitment_mismatches": {"value": t["commitments"], "max": 0},
              "sumcheck_mismatches": {"value": t["sumchecks"], "max": 0},
              "evaluation_mismatches": {"value": t["evaluations"], "max": 0},
              "byte_mismatches": {"value": t["bytes"], "max": 0}}
    if verifies:
        checks["tamper_accepted"] = {"value": tamper_accepted, "max": 0}
    return checks, picked, ref_s


def run(cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
        t_start: float = T_START) -> Optional[dict]:
    """One run of `cell`; returns the result, or None when the process
    holds JAX or the JAX package once the window has closed."""
    import torch

    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    phases = tuple(cell.traffic["phases"])
    loop = spec.loop(cell.traffic)
    reference = spec.reference(cell.config)
    driver = spec.driver(cell.config)
    readers = spec.readers(cell.per_layer if trace else cell.end_to_end)
    t_setup = time.perf_counter()
    drv = driver.setup(cell.config, cell.traffic, seed, device)
    t_warm = time.perf_counter()
    warm = run_job(-1, phases, drv.call, sync)
    _log(f"set-up: start to driver {t_setup - t_start:.3f} s, driver "
         f"{t_warm - t_setup:.3f} s, warm-up job {time.perf_counter() - t_warm:.3f} s")
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    first, tr = None, None
    setup_s = time.perf_counter() - t_start
    if trace:
        win, first, tr = _trace_window(drv, phases, loop, seconds, sync, cuda)
    else:
        win = loop.run(seconds, 0, phases, drv.call, sync)
        setup_s = win.start - t_start
    sync()
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    peak = max(setup_peak, window_peak)
    rec = RunRecord(window=win, setup_s=setup_s,
                    window_peak_bytes=window_peak if not trace else None, trace=tr)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = readers[m["name"]].read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": cell.chips, "memory_peak_bytes": int(peak)}
    if trace and tr.device is not None:
        device_info["busy_s"] = tr.device.busy_s
        device_info["window_s"] = tr.device.window_s

    jobs = ([first] if first is not None else []) + win.jobs
    failed = sum(1 for j in jobs if j.error is not None)
    checks, picked, ref_s = _check(drv, driver.inputs, reference, cell.traffic, jobs,
                                   failed + (warm.error is not None), seed, device)
    ok = all(c["value"] <= c["max"] if "max" in c else c["value"] >= c["min"]
             for c in checks.values())
    for j in [warm] + jobs:
        _log(f"job {j.index}: " + (f"failed: {j.error}" if j.error is not None else
                                   " ".join(f"{ph} {s:.3f} s" for ph, s in j.seconds.items())))
    _log(f"setup {setup_s:.3f} s; window {win.end - win.start:.3f} s, "
         f"{len(win.jobs)} jobs; checked jobs "
         f"{picked} in {ref_s:.1f} s; card {_power_limit() if cuda else 'cpu'}")
    found = jaxguard.forbidden(sys.modules)
    if found:
        _log("the process holds JAX or the JAX package: " + ", ".join(found))
        return None
    for name, c in checks.items():
        limit = f"<= {c['max']}" if "max" in c else f">= {c['min']}"
        _log(f"{name} {c['value']} {limit}")
    result = {"correct": ok, "attempted": len(jobs), "failed": failed,
              "metrics": metrics, "device": device_info}
    if trace and tr.device is not None:
        result["breakdown"] = devtrace.breakdown(tr.device)
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 proofbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(CACHE, sub)
    cell = spec.find_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        _log(f"{args.workload} needs {cell.chips} CUDA device(s); found "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    result = run(cell, args.seed, args.seconds, bool(args.trace))
    if result is None:
        return 4
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
