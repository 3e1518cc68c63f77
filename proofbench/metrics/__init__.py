"""One reader per metric, found by the metric's name
(`spec.metric_reader`): `read(run) -> float | None` over a
`run.RunRecord`.  End-to-end readers read the window; per-layer readers
read `run.trace`, the traced run's spans, counters and device trace,
which is None in an untraced run.  A reader that finds nothing to read
returns None and its metric is left out; a roofline share is never
reported as 0."""
