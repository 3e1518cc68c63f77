"""Subprotocols (`subprotocols/tensorcheck.py`, `streaming/tensorcheck.py`):
the program's span `snark::tensorcheck`, ms/proof over the span window."""


def read(run):
    trace = run.trace
    if trace is None:
        return None
    return trace.span_per_job("snark::tensorcheck")
