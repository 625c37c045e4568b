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
    C3          ConvBnAct_0/1/2 → cv1/cv2/cv3, Bottleneck_j → m.j
    C3Ghost     ConvBnAct_0/1/2 → cv1/cv2/cv3, GhostBottleneck_j → m.j
    Bottleneck  ConvBnAct_0/1 → cv1/cv2
    SPPF        ConvBnAct_0/1 → cv1/cv2
    GhostConv   ConvBnAct_0/1 → cv1/cv2
    GhostBottleneck  GhostConv_0/1 → conv.0/conv.2; at stride 2 also
                DWConv_0 → conv.1, DWConv_1 → shortcut.0,
                ConvBnAct_0 → shortcut.1
    Detect      conv{l}/{kernel,bias} → m.{l}.{weight,bias}
    repeats     m{i}_{r} → model.{i}.{r}.

A gradient tree maps the same way: :func:`grads_from_jax` takes the JAX
``params`` gradients (``jax.grad`` of the same loss) and returns them by
the port's parameter names, so they compare key for key with the port's
``named_parameters`` gradients.
"""

from __future__ import annotations

import numpy as np
import torch


def _cba(tp: str, jp: tuple) -> list:
    """(torch key, tree path, kind) entries of one ConvBnAct."""
    return [
        (f"{tp}conv.weight", ("params", *jp, "Conv_0", "kernel"), "conv"),
        (f"{tp}bn.weight", ("params", *jp, "BatchNorm_0", "scale"), "vec"),
        (f"{tp}bn.bias", ("params", *jp, "BatchNorm_0", "bias"), "vec"),
        (f"{tp}bn.running_mean", ("batch_stats", *jp, "BatchNorm_0", "mean"),
         "vec"),
        (f"{tp}bn.running_var", ("batch_stats", *jp, "BatchNorm_0", "var"),
         "vec"),
        (f"{tp}bn.num_batches_tracked", None, "count"),
    ]


def _pair(tp: str, jp: tuple) -> list:
    """cv1/cv2 ← ConvBnAct_0/1 (Bottleneck, SPPF, GhostConv)."""
    return (_cba(f"{tp}cv1.", (*jp, "ConvBnAct_0"))
            + _cba(f"{tp}cv2.", (*jp, "ConvBnAct_1")))


def _ghost_bottleneck(tp: str, jp: tuple, s: int) -> list:
    out = (_pair(f"{tp}conv.0.", (*jp, "GhostConv_0"))
           + _pair(f"{tp}conv.2.", (*jp, "GhostConv_1")))
    if s == 2:
        out += (_cba(f"{tp}conv.1.", (*jp, "DWConv_0", "ConvBnAct_0"))
                + _cba(f"{tp}shortcut.0.", (*jp, "DWConv_1", "ConvBnAct_0"))
                + _cba(f"{tp}shortcut.1.", (*jp, "ConvBnAct_0")))
    return out


def _module_entries(kind: str, args: tuple, frm, tp: str, jp: tuple) -> list:
    if kind == "Conv":
        return _cba(tp, jp)
    if kind == "DWConv":
        return _cba(tp, (*jp, "ConvBnAct_0"))
    if kind in ("Bottleneck", "SPPF", "GhostConv"):
        return _pair(tp, jp)
    if kind == "GhostBottleneck":
        return _ghost_bottleneck(tp, jp, args[3] if len(args) > 3 else 1)
    if kind in ("C3", "C3Ghost"):
        out = (_cba(f"{tp}cv1.", (*jp, "ConvBnAct_0"))
               + _cba(f"{tp}cv2.", (*jp, "ConvBnAct_1"))
               + _cba(f"{tp}cv3.", (*jp, "ConvBnAct_2")))
        for j in range(args[2] if len(args) > 2 else 1):
            if kind == "C3":
                out += _pair(f"{tp}m.{j}.", (*jp, f"Bottleneck_{j}"))
            else:
                out += _ghost_bottleneck(f"{tp}m.{j}.",
                                         (*jp, f"GhostBottleneck_{j}"), 1)
        return out
    if kind == "Detect":
        out = []
        for li in range(len(frm)):
            out.append((f"{tp}m.{li}.weight", ("params", *jp, f"conv{li}",
                                               "kernel"), "conv"))
            out.append((f"{tp}m.{li}.bias", ("params", *jp, f"conv{li}",
                                             "bias"), "vec"))
        return out
    if kind in ("Concat", "Upsample"):
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
