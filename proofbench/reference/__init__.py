"""The benchmark's plain references, one module a proof system, named by
a configuration's key `reference` (`spec.reference`).  `snark.py` is the
Gemini SNARK proof worked out in plain PyTorch and pure Python over
`fr.py` and `g1.py`, with a frozen copy of the Merlin transcript
(`transcript.py`, see its note).

A reference module has three functions:

- `prove(statement, key, commit_filter=...)`: the proof of the statement
  under the key's trapdoor, both as the configuration's driver makes them
  (`inputs(traffic, seed, k, device)`); `commit_filter` maps every vector
  before it is committed (the identity by default; the control's
  truncation in `control.py`);
- `parts(proof)`: a dict of the lists `commitments`, `sumchecks` and
  `evaluations`, compared item by item with the driver's `parts` of the
  program's proof (`correct.mismatches`);
- `proof_bytes(proof)`: the proof's serialized bytes.

A reference imports nothing of the program under test and takes nothing
the program made: the harness hands it the statement and the key's
trapdoor that it made itself."""
