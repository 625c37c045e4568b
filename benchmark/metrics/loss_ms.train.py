"""Host ms a train step inside the port's ``train.loss`` span (target
assignment and the loss's launches), traced over one update's steps."""

from benchmark.port_spans import host_ms


def read(obs):
    return host_ms(obs, "train_step", ("train.loss",))
