"""The chip's published peaks and the least time each port kernel needs at
a cell's shapes (the arithmetic of the port's ``chip_smoke.py`` phases b
and b', evaluated at the shapes the cell's model and batch give).

A bound is the larger of the operations over their peak rate and the
bytes over the memory bandwidth, each input read once and each output
written once.  Peaks: one NVIDIA H100 SXM, dense, at its 700 W limit.
"""

from __future__ import annotations

import math

PEAK_BF16 = 989e12  # FLOP/s, tensor cores, dense
PEAK_FP32 = 67e12  # FLOP/s, float32 outside the tensor cores
PEAK_BYTES = 3.35e12  # bytes/s, HBM3
ACT_OPS = 5  # float32 operations of one scale + shift + SiLU


def bound_s(nbytes: float, *work) -> float:
    """Least seconds for ``nbytes`` and ``work``: pairs of (operations,
    peak rate)."""
    return max(sum(ops / peak for ops, peak in work), nbytes / PEAK_BYTES)


def widths(model_dict: dict) -> dict:
    """The channel counts and repeats of layers 0-3 (the stem, the layer-1
    downsample, the layer-2 C3 and the layer-3 downsample) after width
    and depth scaling."""
    gw, gd = model_dict["width_multiple"], model_dict["depth_multiple"]
    layers = model_dict["backbone"]
    ch = lambda i: math.ceil(layers[i][3][0] * gw / 8) * 8
    n2 = layers[2][1]
    return {"c0": ch(0), "c1": ch(1), "c2": ch(2), "c3": ch(3),
            "n2": max(round(n2 * gd), 1) if n2 > 1 else n2}


def infer_rows(model_dict: dict, batch: int, imgsz: int) -> dict:
    """Seconds of the inference rows at one predict call: 1 the stem+L1
    kernel (layers 0-1), 2 the C3 kernel (layer 2), 3 the downsample
    kernel (layer 3)."""
    w = widths(model_dict)
    B, hs = batch, imgsz // 2
    c2, c3 = w["c0"], w["c1"]
    f_stem = 2 * B * hs * hs * 108 * c2
    f_l1 = 2 * B * (hs // 2) ** 2 * 9 * c2 * c3
    stem = bound_s(B * imgsz * imgsz * 3 + B * (hs // 2) ** 2 * c3 * 2,
                   (3 * f_stem, PEAK_BF16), (f_l1, PEAK_BF16))
    c, n, H = w["c2"], w["n2"], imgsz // 4
    c_ = c // 2
    macs = c * c_ + n * (c_ * c_ + 9 * c_ * c_) + c * c_ + 2 * c_ * c
    acts = c_ + n * 2 * c_ + c_ + c
    c3k = max(bound_s(2 * B * H * H * c * 2, (2 * B * H * H * macs,
                                              PEAK_BF16)),
              B * H * H * acts * ACT_OPS / PEAK_FP32)
    ci, co = w["c2"], w["c3"]
    down = bound_s(B * H * H * ci * 2 + B * (H // 2) ** 2 * co * 2,
                   (2 * B * (H // 2) ** 2 * 9 * ci * co, PEAK_BF16))
    return {"stem_l1": stem, "c3": c3k, "down": down}


def train_rows(model_dict: dict, batch: int, imgsz: int) -> dict:
    """Seconds of the train rows at one step: 7a/7b the stem's forward and
    weight gradient, 8a/8b the layer-1 and layer-3 downsamples' forward
    and weight gradient (both layers together)."""
    w = widths(model_dict)
    B, hs, c2 = batch, imgsz // 2, w["c0"]
    f = 2 * B * hs * hs * 108 * c2
    nbytes = B * imgsz * imgsz * 3 + B * hs * hs * c2 * 2 + 108 * c2 * 4
    out = {"stem_train_fwd": bound_s(nbytes, (3 * f, PEAK_BF16)),
           "stem_train_wgrad": bound_s(nbytes, (f, PEAK_BF16))}
    fwd_b = wg_b = flops = 0.0
    for ci, co, H in ((w["c0"], w["c1"], imgsz // 2),
                      (w["c2"], w["c3"], imgsz // 4)):
        flops += 2 * B * (H // 2) ** 2 * 9 * ci * co
        io = B * H * H * ci * 2 + B * (H // 2) ** 2 * co * 2
        fwd_b += io + 9 * ci * co * 2
        wg_b += io + 9 * ci * co * 4
    out["down_train_fwd"] = bound_s(fwd_b, (flops, PEAK_BF16))
    out["down_train_wgrad"] = bound_s(wg_b, (flops, PEAK_BF16))
    return out


# the device trace's kernel names (substrings) of the rows together; the
# two weight gradients end in the same partial-sum kernel
INFER_KERNELS = ("stem_l1_kernel", "c3_kernel", "conv3x3_mma")
TRAIN_KERNELS = ("stem_fwd_kernel", "stem_wgrad_kernel", "conv3x3_mma",
                 "down_wgrad_kernel", "sum_partials")
# launches a predict call / a train step makes of each row's entry point
# (the port's ``Kernel.launches`` counters)
INFER_LAUNCHES = {"stem_l1": 1, "c3": 1, "down": 1}
TRAIN_LAUNCHES = {"stem_train_fwd": 1, "stem_train_wgrad": 1,
                  "down_train_fwd": 2, "down_train_wgrad": 2}
