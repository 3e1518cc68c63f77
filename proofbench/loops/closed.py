"""A closed loop with one client: the next job starts when the last one
has finished, while the clock is before the deadline."""

from proofbench.window import run_window as run  # noqa: F401
