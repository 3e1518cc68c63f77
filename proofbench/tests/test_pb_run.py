"""A whole run of each configuration at a toy size on the CPU (the
harness's look for a chip skipped), sound and with the timed path broken
underneath: each fault that a one-chip SNARK cell can have has to turn
`correct` false.  A one-chip cell has no exchange between chips."""

import time

import pytest

from proofbench import run as bench_run
from proofbench.tests.conftest import tiny

CELLS = ["snark_time.i18", "snark_elastic.i22"]
SEED = 2 ** 31 + 99


def _run(cell_name, trace=False, seconds=1.0):
    cell = tiny(cell_name)
    res = bench_run.run(cell, SEED, seconds, trace, device="cpu",
                        t_start=time.perf_counter())
    assert res is not None
    return cell, res


@pytest.mark.parametrize("name", CELLS)
def test_sound_run(name):
    cell, res = _run(name)
    assert res["correct"] is True and res["failed"] == 0
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end} - {"peak_device_gib"} \
        or set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert list(res)[-1] == "checks"
    assert res["checks"]["checked_proofs"]["value"] >= 1


def test_traced_run_reads_spans_and_counters():
    cell, res = _run("snark_time.i18", trace=True)
    assert res["correct"] is True
    for name in ("protocol_self_ms", "sumcheck_ms", "tensorcheck_ms", "batch_commit_ms"):
        assert res["metrics"][name]["value"] > 0
    assert "prove_s" not in res["metrics"]


def _fold_unchanged(monkeypatch):
    from gemini_tpu_torch.subprotocols import sumcheck

    monkeypatch.setattr(sumcheck, "_fold_plain", lambda f, g, t, r, rt: (f, g, t))


def _half_msm(monkeypatch):
    """Half of the lanes left out, the rest counted twice."""
    from gemini_tpu_torch.curve.g1 import APoint
    from gemini_tpu_torch.fields import fp
    from gemini_tpu_torch.fields.fp import FR
    from gemini_tpu_torch.kzg import commit
    from gemini_tpu_torch.ops import msm
    from gemini_tpu_torch.streaming import kzg as skzg

    orig = msm.msm_mont_scalars

    def half(points, scalars, *args, **kw):
        h = max(scalars.shape[1] // 2, 1)
        pts = APoint(points.x[:, :h], points.y[:, :h], points.inf[:h])
        return orig(pts, fp.add(FR, scalars[:, :h], scalars[:, :h]), *args, **kw)

    monkeypatch.setattr(commit, "msm_mont_scalars", half)
    monkeypatch.setattr(skzg, "msm_mont_scalars", half)


def _message_altered(monkeypatch):
    from gemini_tpu_torch.params import R
    from gemini_tpu_torch.subprotocols.sumcheck import TimeProver

    decode = TimeProver.decode_msg

    def altered(ab):
        a, b = decode(ab)
        return (a + 1) % R, b

    monkeypatch.setattr(TimeProver, "decode_msg", staticmethod(altered))


@pytest.mark.parametrize("fault", [_fold_unchanged, _half_msm, _message_altered])
@pytest.mark.parametrize("name", CELLS)
def test_fault_turns_correct_false(monkeypatch, name, fault):
    fault(monkeypatch)
    _, res = _run(name, seconds=0.5)
    assert res["correct"] is False
