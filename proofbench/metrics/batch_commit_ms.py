"""Commitments (`kzg/commit.py`): the program's span
`tensorcheck::batch_commit` (the fold tree's commitments of the time
prover), ms/proof over the span window."""


def read(run):
    trace = run.trace
    if trace is None:
        return None
    return trace.span_per_job("tensorcheck::batch_commit")
