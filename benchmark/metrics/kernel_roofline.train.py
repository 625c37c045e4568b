"""Rows 7a, 7b, 8a, 8b (the stem's and the two downsamples' forward and
weight-gradient kernels) against their least time at the cell's shapes:
Σ bound / Σ traced device time, in percent.  Silent when the trace shows
none of them or the port launches them otherwise than once (stem) and
twice (downsamples) a step."""

from benchmark.metrics_common import roofline


def read(obs):
    return roofline(obs, "train_step")
