"""Mean ms of the model forward alone (CUDA events around ``model(x)``)
over every pool batch of a predict cell."""


def read(obs):
    return obs.get("forward_ms") if obs["kind"] == "predict" else None
