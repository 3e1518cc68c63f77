"""Protocol layer (`snark/proof.py`): the harness's span around each
prove less the program's spans of the layers below it (the witness
commitment, both sumchecks, the tensorcheck); what is left is the
matvecs, zc(alpha), abc_tensored, the transcript and the glue.
ms/proof over the span window."""

BELOW = ("snark::commit w", "snark::sumcheck 1", "snark::sumcheck 2",
         "snark::tensorcheck")


def read(run):
    trace = run.trace
    if trace is None:
        return None
    if not trace.jobs or "prove" not in trace.phase_s:
        return None
    below = sum(trace.spans_ms.get(label, 0.0) for label in BELOW)
    return (trace.phase_s["prove"] * 1e3 - below) / trace.jobs
