"""Set-up: process start (the first line of run.py) to the start of the
first timed job: imports, the kernel libraries from their cache (built
in the checkout's first run), the key, the instances and one warm-up job
of the cell's own shapes."""


def read(run):
    return run.setup_s if run.trace is None else None
