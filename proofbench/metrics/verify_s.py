"""Verifier wall time per proof: all the verify time of the window
(host clock, ending in torch.cuda.synchronize()) over the verifies."""


def read(run):
    return run.window.per_job("verify") if run.trace is None else None
