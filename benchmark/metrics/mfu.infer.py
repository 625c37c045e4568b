"""The whole predict's share of the chip's bf16 peak: the FLOPs of a
batch's forward, counted on the plain reference, times the batches of the
window, over the window's seconds and 989 TFLOP/s, in percent."""

from benchmark.metrics_common import mfu


def read(obs):
    return mfu(obs, "predict")
