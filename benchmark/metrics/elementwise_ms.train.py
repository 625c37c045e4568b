"""Device ms a train step spends in elementwise and reduction kernels (the
float32 BatchNorm + SiLU passes, the loss, the optimizer and the EMA), by
the trace's kernel names."""


def read(obs):
    if obs["kind"] != "train_step":
        return None
    g = obs["trace"].by_group()
    ms = (g.get("elementwise", 0.0) + g.get("reductions", 0.0)) * 1e3
    return ms / obs["trace"].calls or None
