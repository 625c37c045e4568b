"""Share of the train step's train-mode BatchNorm + SiLU calls that ran on
the hand-written kernels (the port's ``bn_act.fused`` counter over its
``bn_act.calls``, over the whole run), in %.  None where the port keeps no
such counter."""


def read(obs):
    if obs["kind"] != "train_step":
        return None
    try:
        from yolov5_obb_tpu_torch.utils.profiler import counters
    except ImportError:
        return None
    c = counters()
    calls = c["bn_act.calls"]
    return 100.0 * c["bn_act.fused"] / calls if calls else None
