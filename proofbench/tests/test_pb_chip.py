"""On the card: a traced run of a small time-prover cell reads the
device trace (busy time, the port's kernels, rooflines at most 100%) and
stays correct."""

import time

import pytest

from proofbench import run as bench_run
from proofbench.tests.conftest import tiny


@pytest.mark.chip
def test_traced_run_on_the_card(cuda_card):
    cell = tiny("snark_time.i18", log2=12)
    res = bench_run.run(cell, 2 ** 31 + 5, 2.0, True, device="cuda",
                        t_start=time.perf_counter())
    assert res is not None and res["correct"] is True
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    for name in ("padd_roofline", "fr_mul_roofline"):
        assert 0 < res["metrics"][name]["value"] <= 100
    assert res["breakdown"]["device_ops"]
