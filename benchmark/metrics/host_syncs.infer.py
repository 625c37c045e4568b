"""Points a post-processing call made the host wait for the device (the
port's ``postproc.host_syncs`` counter over its ``postproc.calls``, over
the whole run): the grid and anchor copies of the decode, the tier's
read, the greedy sweeps' reads.  None where the port keeps no such
counter."""


def read(obs):
    if obs["kind"] != "predict":
        return None
    try:
        from yolov5_obb_tpu_torch.utils.profiler import counters
    except ImportError:
        return None
    c = counters()
    calls = c["postproc.calls"]
    return c["postproc.host_syncs"] / calls if calls else None
