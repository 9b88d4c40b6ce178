"""k3_frames_per_launch: frames decoded in the untraced window over the
launches of the decode kernel K3 in it (x3_tpu_torch.ops.decode_cuda's
launch_count)."""


def read(run):
    if run.direction != "decode" or not run.launches["k3"]:
        return None
    return run.completed_frames / run.launches["k3"]
