"""Each configuration names its plain reference and its driver makes the
reference's inputs: the reference that a configuration names is the one
that `correct` and the control call, so a configuration with a reference
of its own needs no edit of the harness.  CPU, toy sizes."""

import json
import os
import sys
import time

import pytest
import torch

from proofbench import control, instances, spec
from proofbench import run as bench_run
from proofbench.reference import snark
from proofbench.tests.conftest import tiny

BENCH = spec.load_benchmark()
CONFIGS = {c["name"]: c["file"] for c in BENCH["configs"]}
CELLS = ["snark_time.i18", "snark_elastic.i22"]
SEED = 2 ** 31 + 7373
STUB = "proofbench.reference.stub"

STUB_SOURCE = '''"""A stand-in reference: snark.py's proof in a dataclass of its own
(which loads only from a module entered in sys.modules), each call
recorded and, where OFF is set, its first commitment moved."""

from __future__ import annotations

from dataclasses import dataclass

from proofbench.reference import snark

CALLS = []
OFF = False


@dataclass
class Proof:
    inner: snark.Proof


def prove(statement, key, commit_filter=snark._same) -> Proof:
    CALLS.append(commit_filter)
    return Proof(snark.prove(statement, key, commit_filter=commit_filter))


def parts(proof: Proof) -> dict:
    out = snark.parts(proof.inner)
    if OFF:
        out["commitments"][0] = None
    return out


def proof_bytes(proof: Proof) -> bytes:
    return snark.proof_bytes(proof.inner)
'''


def _config(name):
    with open(os.path.join(spec.ROOT, CONFIGS[name])) as f:
        return json.load(f)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_configuration_names_its_reference(name):
    mod = spec.reference(_config(name))
    assert mod.__file__ == os.path.join(spec.HERE, "reference", "snark.py")
    assert mod is snark


def _old_inputs(cell, seed, k):
    """The statement and key as the drivers' `statement(k, device)` and
    `key()` made them before drivers had `inputs` (a frozen copy)."""
    n = 1 << int(cell.traffic["constraints_log2"])
    if cell.config["driver"] == "snark_time":
        insts = [instances.DiagonalInstance(seed, i, n)
                 for i in range(int(cell.traffic["instances"]))]
        return insts[k % len(insts)].statement("cpu"), instances.time_key(seed)
    return instances.DummyInstance(seed, k, n).statement("cpu"), instances.fake_key(seed)


def _same_statement(a, b):
    for m, o in ((a.a, b.a), (a.b, b.b), (a.c, b.c)):
        assert (m.n_rows, m.n_cols) == (o.n_rows, o.n_cols)
        for x, y in ((m.rows, o.rows), (m.cols, o.cols), (m.vals, o.vals)):
            assert torch.equal(x, y)
    assert torch.equal(a.z, b.z) and a.num_inputs == b.num_inputs


@pytest.mark.parametrize("k", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_driver_inputs_are_the_old_statement_and_key(name, k):
    cell = tiny(name)
    st, key = spec.driver(cell.config).inputs(cell.traffic, SEED, k, "cpu")
    old_st, old_key = _old_inputs(cell, SEED, k)
    _same_statement(st, old_st)
    assert (key.tau, key.g) == (old_key.tau, old_key.g)


@pytest.mark.parametrize("change, error, named", [
    ({"reference": "no_such_reference"}, FileNotFoundError,
     "proofbench/reference/no_such_reference.py"),
    ({"reference": None}, KeyError, "configuration 'snark_time' names no plain reference"),
])
def test_unknown_reference_fails_at_setup(monkeypatch, change, error, named):
    cell = tiny("snark_time.i18")
    cell.config.update(change)
    if cell.config["reference"] is None:
        del cell.config["reference"]
    monkeypatch.setattr(spec, "driver", lambda config: pytest.fail("set-up reached the driver"))
    with pytest.raises(error, match=named):
        bench_run.run(cell, SEED, 0.1, False, device="cpu", t_start=time.perf_counter())


@pytest.mark.parametrize("change, error, named", [
    ({"reference": "no_such_reference"}, FileNotFoundError,
     "proofbench/reference/no_such_reference.py"),
    ({"reference": None}, KeyError, "proofbench/configs/snark_time.json names no plain"),
])
def test_configuration_file_without_its_reference_is_refused(tmp_path, change, error, named):
    cfg = _config("snark_time")
    cfg.update(change)
    if cfg["reference"] is None:
        del cfg["reference"]
    path = tmp_path / CONFIGS["snark_time"]
    path.parent.mkdir(parents=True)
    path.write_text(json.dumps(cfg))
    with pytest.raises(error, match=named):
        spec.find_cell("snark_time.i18", bench=BENCH, root=str(tmp_path))


@pytest.fixture
def stub_cell(tmp_path, monkeypatch):
    """The cell `name` at a toy size with the reference `stub`, a file
    outside reference/ that spec's loader finds by the configuration's
    key."""
    def make(name):
        cell = tiny(name)
        cell.config["reference"] = "stub"
        (tmp_path / "stub.py").write_text(STUB_SOURCE)
        monkeypatch.setattr(spec, "REFERENCES", str(tmp_path))
        return cell

    yield make
    sys.modules.pop(STUB, None)


@pytest.mark.parametrize("name", CELLS)
def test_run_checks_against_the_configuration_reference(stub_cell, name):
    cell = stub_cell(name)
    res = bench_run.run(cell, SEED, 0.5, False, device="cpu", t_start=time.perf_counter())
    stub = sys.modules[STUB]
    checked = res["checks"]["checked_proofs"]["value"]
    assert res["correct"] is True and checked >= 1
    assert stub.CALLS == [snark._same] * checked
    stub.OFF = True
    res = bench_run.run(cell, SEED + 1, 0.5, False, device="cpu", t_start=time.perf_counter())
    assert res["correct"] is False
    assert res["checks"]["commitment_mismatches"]["value"] == \
        res["checks"]["checked_proofs"]["value"]


@pytest.mark.parametrize("name", CELLS)
def test_control_uses_the_configuration_reference(stub_cell, name):
    out = control.readings(stub_cell(name), SEED, "cpu")
    assert sys.modules[STUB].CALLS == [snark._same, control.truncate]
    assert out["control"]["commitments"] > 0 and out["control"]["bytes"] > 0
