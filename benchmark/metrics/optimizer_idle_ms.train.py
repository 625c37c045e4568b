"""Device-idle ms a train step whose gap lies (by its middle) inside the
port's ``train.optimizer`` or ``train.ema`` span, traced over one
update's steps."""

from benchmark.port_spans import idle_ms


def read(obs):
    return idle_ms(obs, "train_step", ("train.optimizer", "train.ema"))
