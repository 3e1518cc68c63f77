"""One module per kind of load (a traffic mix's `loop`), found by name
(`spec.loop`): `run(seconds, first_index, phases, call, sync) -> Window`."""
