"""Rows 1-3 (the stem+L1, C3 and downsample kernels) against their least
time at the cell's shapes: Σ bound / Σ traced device time, in percent.
Silent when the trace shows none of them or the port no longer launches
each once a predict call."""

from benchmark.metrics_common import roofline


def read(obs):
    return roofline(obs, "predict")
