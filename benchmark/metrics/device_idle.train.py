"""The share of the traced slice (one train step, ended by reading its
loss) in which no device operation ran, in percent."""

from benchmark.metrics_common import idle


def read(obs):
    return idle(obs, "train_step")
