"""The share of the traced slice (two predict calls with their read-backs)
in which no device operation ran, in percent."""

from benchmark.metrics_common import idle


def read(obs):
    return idle(obs, "predict")
