"""Every cell is found by name, with its configuration, traffic and
metric files; the JAX check; the window arithmetic; the work table."""

import json
import os

import pytest

from proofbench import jaxguard, roofline, spec
from proofbench.window import run_window

BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_found_by_name(name):
    cell = spec.find_cell(name)
    assert cell.config["name"] == next(w["config"] for w in BENCH["workloads"]
                                       if w["name"] == name)
    assert spec.driver(cell.config).setup
    assert spec.loop(cell.traffic).run
    names = {m["name"] for m in cell.end_to_end}
    assert {"setup_s", "prove_s"} <= names
    for m in cell.end_to_end + cell.per_layer:
        assert callable(spec.metric_reader(m["name"]).read)
    assert cell.per_layer


def test_unknown_cell_raises():
    with pytest.raises(KeyError):
        spec.find_cell("no_such.cell")


def test_files_stay_under_paths():
    for c in BENCH["configs"]:
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        with open(os.path.join(spec.ROOT, c["file"])) as f:
            assert json.load(f)["name"] == c["name"]


@pytest.mark.parametrize("names, found", [
    (["gemini_tpu", "os"], ["gemini_tpu"]),
    (["jax.numpy"], ["jax.numpy"]),
    (["jaxlib", "flax.linen"], ["flax.linen", "jaxlib"]),
    (["gemini_tpu_torch.fields", "gemini_tpu_torch", "jaxtyping"], []),
])
def test_jax_guard(names, found):
    assert jaxguard.forbidden(names) == found


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def test_window_counts_the_proof_in_flight():
    clock = FakeClock()

    def call(phase, k, prev):
        clock.t += {"prove": 4.0, "verify": 1.0}[phase]
        return k

    win = run_window(10.0, 0, ("prove", "verify"), call, lambda: None, clock)
    # jobs start at 0, 5 (before the deadline at 10) and not at 10
    assert [j.start - 100.0 for j in win.jobs] == [0.0, 5.0]
    assert win.per_job("prove") == 4.0 and win.per_job("verify") == 1.0

    clock2 = FakeClock()

    def slow(phase, k, prev):
        clock2.t += 3.0
        return k

    win2 = run_window(10.0, 0, ("prove",), slow, lambda: None, clock2)
    # starts at 0, 3, 6, 9 (< 10); the fourth ends at 12 and counts
    assert len(win2.jobs) == 4 and win2.end - win2.start == 12.0
    assert win2.per_job("prove") == 3.0


def test_failed_job_is_counted():
    clock = FakeClock()

    def call(phase, k, prev):
        clock.t += 1.0
        if k == 1 and phase == "verify":
            raise ValueError("rejected")
        return k

    win = run_window(3.5, 0, ("prove", "verify"), call, lambda: None, clock)
    assert win.failed == 1
    assert win.per_job("verify") == 1.0  # the failed verify is not counted


def test_work_table_by_hand():
    # An Fq product: 12 words, 2*144 + 12 = 300 word products; padd's 12
    # products; 2 input points and 1 output point of 3 coordinates of
    # 24 int32 limbs.
    assert roofline.PADD.imad == 12 * 300
    assert roofline.PADD.bytes == 9 * 24 * 4
    # An Fr product: 8 words, 2*64 + 8 = 136; a and the output, 16 limbs.
    assert roofline.FR_MUL.imad == 136
    assert roofline.FR_MUL.bytes == 2 * 16 * 4
    lanes = 1 << 20
    peak_ops = 132 * 1.98e9 * 64
    ops_s = lanes * 3600 / peak_ops
    bytes_s = lanes * 864 / 3.35e12
    assert bytes_s > ops_s  # bytes bound padd
    assert roofline.PADD.least_seconds(lanes) == pytest.approx(bytes_s)


def test_device_trace_union_and_gap_names():
    from proofbench import devtrace

    # profiler microseconds; host time = profiler seconds + 1000
    events = [("(anonymous namespace)::padd_kernel(int*)", 0, 100_000),
              ("(anonymous namespace)::padd_kernel(int*)", 50_000, 150_000),
              ("void at::native::fill_kernel<float>", 400_000, 500_000)]
    spans = [("bench::prove", 1000.0, 1001.0), ("snark::tensorcheck", 1000.2, 1000.35)]
    dt = devtrace.read_events(events, 1000.0, 1001.0, 1000.0, spans)
    assert dt.busy_s == pytest.approx(0.25) and dt.window_s == pytest.approx(1.0)
    assert dt.events == 3 and dt.kernel_s["padd_kernel"] == pytest.approx(0.2)
    assert dt.library_s("g1") == pytest.approx(0.2) and dt.library_s("fr") == 0
    # gaps: 0.15-0.40 (middle 0.275, in tensorcheck) and 0.50-1.00
    assert dt.gaps == [("snark::tensorcheck", pytest.approx(0.25)),
                       ("bench::prove", pytest.approx(0.5))]
    top = devtrace.breakdown(dt)
    assert top["idle_gaps"][0][0] == "bench::prove"
    assert top["device_ops"][0][0] == "padd_kernel"
