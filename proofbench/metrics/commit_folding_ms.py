"""Streaming (`streaming/`, `relation/stream.py`): the program's span
`tensorcheck::commit_folding` (the elastic prover's streamed fold-tree
commitments), ms/proof over the span window."""


def read(run):
    trace = run.trace
    if trace is None:
        return None
    return trace.span_per_job("tensorcheck::commit_folding")
