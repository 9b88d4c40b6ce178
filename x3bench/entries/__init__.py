"""Entry drivers: how a traffic mix's `entry` is called.

Each module here, found by the name a traffic file gives, defines
DIRECTION ("encode" or "decode"), `prepare(streams, sample_rate, params,
device)` (set-up: the inputs a call takes), `call(inputs, sample_rate,
params, device)` (one call of the program, the thing the window times),
`batches(streams, samples_per_frame)` (the encode batches a call's inputs
make, None for a decode) and `check(inputs, outputs, streams,
sample_rate, ref)` (the numbers compare.LIMITS holds)."""
