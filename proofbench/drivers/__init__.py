"""One driver per configuration kind, named by the configuration's
`driver` key (`spec.driver`).  A driver's `setup(config, traffic, seed,
device)` returns an object with `call(phase, index, previous)` for the
phases its traffic names, and what the correctness check needs:
`proof_bytes`, `parts`, `statement`, `key`, `release`, and
`tamper_rejected` where the traffic verifies."""
