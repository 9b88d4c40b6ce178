"""One reader a metric: metrics/<name>.py defines read(run), which gives
the metric's value from the run's records (harness.Run) or None where it
finds nothing to read, and the harness then leaves the metric out.  A
metric named for one direction (`call_p95_ms.decode`, `decode_mbs`) may
share the reader of its stem (`call_p95_ms.py`, `mbs.py`): the harness
then hands it only the runs of that direction (harness.load_reader)."""
