"""Carry weights from the JAX package's variable tree into the port.

:func:`from_jax_variables` takes the ``{"params", "batch_stats"}`` tree of a
JAX yolov5 model as numpy arrays (for example ``utils/checkpoint.load_weights``
output passed through ``np.asarray``) and returns a ``state_dict`` for the
port's ``YoloModel`` of the same config: conv kernels HWIO → OIHW, BatchNorm
``scale/bias/mean/var`` → ``weight/bias/running_mean/running_var``.

Key map, per graph layer ``m{i}`` → ``model.{i}.`` (the reference PyTorch
model's names):

    Conv        Conv_0 → conv, BatchNorm_0 → bn
    DWConv      ConvBnAct_0/{Conv_0, BatchNorm_0} → conv, bn
    Focus       ConvBnAct_0 → conv
    C3, C3Ghost ConvBnAct_0/1/2 → cv1/cv2/cv3, Bottleneck_j or
                GhostBottleneck_j → m.j
    C3TR        ConvBnAct_0/1/2 → cv1/cv2/cv3, TransformerBlock_0 → m:
                Dense_0 → linear, TransformerLayer_j → tr.j with
                q/k/v/fc1/fc2 and MultiHeadDotProductAttention_0/
                {query,key,value,out} → ma.{query,key,value,out}
    C3SPP       ConvBnAct_0/1/2 → cv1/cv2/cv3, SPP_0 → m
    BottleneckCSP  ConvBnAct_0/1 → cv1/cv4, Conv_0/1 → cv3/cv2,
                BatchNorm_0 → bn, Bottleneck_j → m.j
    Bottleneck, SPP, SPPF, GhostConv  ConvBnAct_0/1 → cv1/cv2
    GhostBottleneck  GhostConv_0/1 → conv.0/conv.2; at stride 2 also
                DWConv_0 → conv.1, DWConv_1 → shortcut.0,
                ConvBnAct_0 → shortcut.1
    CrossConv   Conv_0/BatchNorm_0 → cv1, Conv_1/BatchNorm_1 → cv2
    MixConv2d   Conv_i → m.i, BatchNorm_0 → bn
    Sum         w → w (weighted only)
    Classify    Conv_0/{kernel,bias} → conv.{weight,bias}
    Detect      conv{l}/{kernel,bias} → m.{l}.{weight,bias}
    repeats     m{i}_{r} → model.{i}.{r}.

Dense kernels ``(in, out)`` become ``(out, in)``; the attention's
``(c, heads, d)`` projections ``(heads·d, c)``, its ``(heads, d, c)`` output
``(c, heads·d)``, and its ``(heads, d)`` biases vectors.

A gradient tree maps the same way: :func:`grads_from_jax` takes the JAX
``params`` gradients (``jax.grad`` of the same loss) and returns them by
the port's parameter names, so they compare key for key with the port's
``named_parameters`` gradients.
"""

from __future__ import annotations

import numpy as np
import torch


def _cba(tp: str, jp: tuple, conv: str = "Conv_0",
         bn: str = "BatchNorm_0") -> list:
    """(torch key, tree path, kind) entries of one ConvBnAct: its conv and
    BatchNorm, by default ``Conv_0``/``BatchNorm_0`` under ``jp``."""
    return [(f"{tp}conv.weight", ("params", *jp, conv, "kernel"), "conv"),
            *_bn(f"{tp}bn.", (*jp, bn))]


def _bn(tp: str, jp: tuple) -> list:
    return [
        (f"{tp}weight", ("params", *jp, "scale"), "vec"),
        (f"{tp}bias", ("params", *jp, "bias"), "vec"),
        (f"{tp}running_mean", ("batch_stats", *jp, "mean"), "vec"),
        (f"{tp}running_var", ("batch_stats", *jp, "var"), "vec"),
        (f"{tp}num_batches_tracked", None, "count"),
    ]


def _pair(tp: str, jp: tuple) -> list:
    """cv1/cv2 ← ConvBnAct_0/1 (Bottleneck, SPP, SPPF, GhostConv)."""
    return (_cba(f"{tp}cv1.", (*jp, "ConvBnAct_0"))
            + _cba(f"{tp}cv2.", (*jp, "ConvBnAct_1")))


def _c3_outer(tp: str, jp: tuple) -> list:
    """A C3 family block's cv1/cv2/cv3 ← ConvBnAct_0/1/2."""
    return (_cba(f"{tp}cv1.", (*jp, "ConvBnAct_0"))
            + _cba(f"{tp}cv2.", (*jp, "ConvBnAct_1"))
            + _cba(f"{tp}cv3.", (*jp, "ConvBnAct_2")))


def _ghost_bottleneck(tp: str, jp: tuple, s: int) -> list:
    out = (_pair(f"{tp}conv.0.", (*jp, "GhostConv_0"))
           + _pair(f"{tp}conv.2.", (*jp, "GhostConv_1")))
    if s == 2:
        out += (_cba(f"{tp}conv.1.", (*jp, "DWConv_0", "ConvBnAct_0"))
                + _cba(f"{tp}shortcut.0.", (*jp, "DWConv_1", "ConvBnAct_0"))
                + _cba(f"{tp}shortcut.1.", (*jp, "ConvBnAct_0")))
    return out


def _dense(tp: str, jp: tuple, bias: bool = False, kind: str = "dense"
           ) -> list:
    out = [(f"{tp}weight", ("params", *jp, "kernel"), kind)]
    if bias:
        out.append((f"{tp}bias", ("params", *jp, "bias"), "vec"))
    return out


def _transformer_block(tp: str, jp: tuple, n: int, conv: bool) -> list:
    out = _cba(f"{tp}conv.", (*jp, "ConvBnAct_0")) if conv else []
    out += _dense(f"{tp}linear.", (*jp, "Dense_0"), bias=True)
    for j in range(n):
        lp, ljp = f"{tp}tr.{j}.", (*jp, f"TransformerLayer_{j}")
        for name in ("q", "k", "v", "fc1", "fc2"):
            out += _dense(f"{lp}{name}.", (*ljp, name))
        mjp = (*ljp, "MultiHeadDotProductAttention_0")
        for name in ("query", "key", "value"):
            out += _dense(f"{lp}ma.{name}.", (*mjp, name), True, "heads_in")
        out += _dense(f"{lp}ma.out.", (*mjp, "out"), True, "heads_out")
    return out


def _module_entries(kind: str, args: tuple, frm, tp: str, jp: tuple) -> list:
    if kind == "Conv":
        return _cba(tp, jp)
    if kind == "DWConv":
        return _cba(tp, (*jp, "ConvBnAct_0"))
    if kind == "Focus":
        return _cba(f"{tp}conv.", (*jp, "ConvBnAct_0"))
    if kind in ("Bottleneck", "SPP", "SPPF", "GhostConv"):
        return _pair(tp, jp)
    if kind == "GhostBottleneck":
        return _ghost_bottleneck(tp, jp, args[3] if len(args) > 3 else 1)
    n = args[2] if len(args) > 2 else 1
    if kind in ("C3", "C3Ghost"):
        out = _c3_outer(tp, jp)
        for j in range(n):
            if kind == "C3":
                out += _pair(f"{tp}m.{j}.", (*jp, f"Bottleneck_{j}"))
            else:
                out += _ghost_bottleneck(f"{tp}m.{j}.",
                                         (*jp, f"GhostBottleneck_{j}"), 1)
        return out
    if kind == "C3TR":
        return _c3_outer(tp, jp) + _transformer_block(
            f"{tp}m.", (*jp, "TransformerBlock_0"), n, conv=False)
    if kind == "C3SPP":
        return _c3_outer(tp, jp) + _pair(f"{tp}m.", (*jp, "SPP_0"))
    if kind == "BottleneckCSP":
        out = (_cba(f"{tp}cv1.", (*jp, "ConvBnAct_0"))
               + _cba(f"{tp}cv4.", (*jp, "ConvBnAct_1"))
               + [(f"{tp}cv3.weight", ("params", *jp, "Conv_0", "kernel"),
                   "conv"),
                  (f"{tp}cv2.weight", ("params", *jp, "Conv_1", "kernel"),
                   "conv")]
               + _bn(f"{tp}bn.", (*jp, "BatchNorm_0")))
        for j in range(n):
            out += _pair(f"{tp}m.{j}.", (*jp, f"Bottleneck_{j}"))
        return out
    if kind == "CrossConv":
        return (_cba(f"{tp}cv1.", jp, "Conv_0", "BatchNorm_0")
                + _cba(f"{tp}cv2.", jp, "Conv_1", "BatchNorm_1"))
    if kind == "MixConv2d":
        k = args[2] if len(args) > 2 else (1, 3)
        return ([(f"{tp}m.{i}.weight", ("params", *jp, f"Conv_{i}", "kernel"),
                  "conv") for i in range(len(k))]
                + _bn(f"{tp}bn.", (*jp, "BatchNorm_0")))
    if kind == "Sum":
        weight = len(args) > 1 and args[1]
        return [(f"{tp}w", ("params", *jp, "w"), "vec")] if weight else []
    if kind == "Classify":
        return [(f"{tp}conv.weight", ("params", *jp, "Conv_0", "kernel"),
                 "conv"),
                (f"{tp}conv.bias", ("params", *jp, "Conv_0", "bias"), "vec")]
    if kind == "Detect":
        out = []
        for li in range(len(frm)):
            out.append((f"{tp}m.{li}.weight", ("params", *jp, f"conv{li}",
                                               "kernel"), "conv"))
            out.append((f"{tp}m.{li}.bias", ("params", *jp, f"conv{li}",
                                             "bias"), "vec"))
        return out
    if kind in ("Concat", "Upsample", "MaxPool", "Contract", "Expand"):
        return []
    raise NotImplementedError(f"no weight map for module {kind!r}")


def key_map(specs) -> list:
    """``(torch key, tree path | None, kind)`` for every parameter and BN
    statistic of the port model built from ``specs``."""
    out = []
    for spec in specs:
        if spec.repeats == 1 or spec.name == "Detect":
            out += _module_entries(spec.name, spec.args, spec.frm,
                                   f"model.{spec.index}.", (f"m{spec.index}",))
        else:
            for r in range(spec.repeats):
                out += _module_entries(spec.name, spec.args, spec.frm,
                                       f"model.{spec.index}.{r}.",
                                       (f"m{spec.index}_{r}",))
    return out


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree, np.float32)


def _to_torch(tree, entries) -> dict:
    sd = {}
    missing = []
    for key, path, kind in entries:
        if kind == "count":
            sd[key] = torch.tensor(0)
            continue
        try:
            v = _get(tree, path)
        except KeyError:
            missing.append("/".join(path))
            continue
        if kind == "conv":
            v = v.transpose(3, 2, 0, 1)  # HWIO → OIHW
        elif kind == "dense":
            v = v.T  # (in, out) → (out, in)
        elif kind == "heads_in":
            v = v.reshape(v.shape[0], -1).T  # (c, heads, d) → (heads·d, c)
        elif kind == "heads_out":
            v = v.reshape(-1, v.shape[-1]).T  # (heads, d, c) → (c, heads·d)
        else:
            v = v.reshape(-1)  # a vector; an attention bias (heads, d)
        sd[key] = torch.from_numpy(np.array(v))
    if missing:
        raise KeyError(f"{len(missing)} entries absent from the tree, e.g. "
                       f"{missing[:5]} — wrong config for these weights?")
    return sd


def from_jax_variables(variables, specs) -> dict:
    """JAX ``{"params", "batch_stats"}`` tree (numpy leaves) + the parsed
    specs of the same config → the port's ``state_dict``."""
    return _to_torch(variables, key_map(specs))


def grads_from_jax(grads, specs) -> dict:
    """JAX gradient tree (the ``params`` layout, numpy leaves) + the parsed
    specs → ``{port parameter name: gradient}``; the BatchNorm statistics
    take no gradient and have no entry."""
    return _to_torch({"params": grads},
                     [e for e in key_map(specs)
                      if e[1] is not None and e[1][0] == "params"])
