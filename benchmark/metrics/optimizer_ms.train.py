"""Host ms a train step inside the port's ``train.optimizer`` and
``train.ema`` spans (the per-leaf optimizer and EMA loops), traced over
one update's steps."""

from benchmark.port_spans import host_ms


def read(obs):
    return host_ms(obs, "train_step", ("train.optimizer", "train.ema"))
