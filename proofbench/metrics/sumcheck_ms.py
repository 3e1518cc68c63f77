"""Subprotocols (`subprotocols/sumcheck.py`, `streaming/sumcheck.py`):
the program's spans `snark::sumcheck 1` and `snark::sumcheck 2`, ms/proof
over the span window."""


def read(run):
    trace = run.trace
    if trace is None:
        return None
    return trace.span_per_job("snark::sumcheck 1", "snark::sumcheck 2")
