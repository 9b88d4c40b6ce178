"""k2_launches_per_batch: launches of the encode kernel K2 in the
untraced window (x3_tpu_torch.ops.encode_cuda's launch_count) over the
encode batches its calls' inputs make (frames / 768, rounded up, as the
entry counts them).  Above 1: batches dispatched again after a rung
escalation."""


def read(run):
    if run.direction != "encode" or not run.launches["k2"]:
        return None
    batches = sum(run.batches_per_call[c.client] for c in run.calls if c.ok)
    return run.launches["k2"] / batches if batches else None
