"""Prover wall time per proof: all the prove time of the window (host
clock, each prove ending in torch.cuda.synchronize()) over the proofs
the window completed, the one in flight at the deadline included."""


def read(run):
    return run.window.per_job("prove") if run.trace is None else None
