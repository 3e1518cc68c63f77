"""One driver per configuration kind, named by the configuration's
`driver` key (`spec.driver`).  A driver module has two functions:

- `setup(config, traffic, seed, device)` returns an object with
  `call(phase, index, previous)` for the phases its traffic names, and
  what the correctness check needs of the program's proofs:
  `proof_bytes`, `parts` (in the layout of the configuration's
  reference), `release`, and `tamper_rejected` where the traffic
  verifies;
- `inputs(traffic, seed, k, device)` returns the statement and key that
  the configuration's reference proves job k under, made from the seed
  without the program."""
