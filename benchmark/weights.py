"""Weights and inputs made on the device from the run's seed, in a few
large calls: the same seed gives the same tensors.

Weights (float32, as both the program and the reference keep them): conv
kernels normal with sigma ``1/sqrt(fan_in)``, cut at two sigma; BatchNorm
scale and running variance uniform in [0.9, 1.1], shift and running mean
normal with sigma 0.02 and 0.05; Detect biases at the YOLOv5 priors
(objectness ``log(8 / (640 / stride)²)``, classes and angle bins
``log(0.6 / (nc - 0.999999))``), the class biases spread by a normal of
sigma 2 a (anchor, class) so that some boxes clear a confidence threshold
(the port's ``bench.py`` recipe).  Both drivers then scale the BatchNorm
weights (:func:`quiet_batchnorm`); for inference the running statistics
are settled on the first images (:func:`settle_batchnorm`) and the Detect
weights scaled so the head's outputs vary across cells
(:func:`scale_head`).
"""

from __future__ import annotations

import math

import torch

from .reference.model import ReferenceYolo

CLASS_SPREAD = 2.0
HEAD_SPREAD = 1.0  # std of a Detect output across cells
BN_GAIN = 0.25  # the BatchNorm weights' scale (quiet_batchnorm)


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))


def skeleton(model_dict: dict, nc: int) -> ReferenceYolo:
    with torch.device("meta"):
        return ReferenceYolo(model_dict, nc)


@torch.no_grad()
def state_dict(model_dict: dict, nc: int, seed: int, device) -> dict:
    """The model's state dict (reference and program names alike)."""
    ref = skeleton(model_dict, nc)
    sd = ref.state_dict()
    g = generator(seed, device)
    convs = [k for k, v in sd.items() if k.endswith("weight") and v.dim() == 4]
    bn_vec = [k for k, v in sd.items() if ".bn." in k and v.dim() == 1
              and v.is_floating_point()]
    total = sum(sd[k].numel() for k in convs)
    flat = torch.randn(total, generator=g, device=device).clamp_(-2.0, 2.0)
    out, at = {}, 0
    for k in convs:
        v = sd[k]
        fan_in = v[0].numel()
        out[k] = (flat[at:at + v.numel()].view(v.shape)
                  / (math.sqrt(fan_in) * 0.87962566103423978))
        at += v.numel()
    nbn = sum(sd[k].numel() for k in bn_vec)
    u = torch.rand(nbn, generator=g, device=device)
    z = torch.randn(nbn, generator=g, device=device)
    at = 0
    for k in bn_vec:
        n = sd[k].numel()
        kind = k.rsplit(".", 1)[1]
        out[k] = {"weight": 0.9 + 0.2 * u[at:at + n],
                  "running_var": 0.9 + 0.2 * u[at:at + n],
                  "bias": 0.02 * z[at:at + n],
                  "running_mean": 0.05 * z[at:at + n]}[kind].clone()
        at += n
    for k, v in sd.items():
        if k.endswith("num_batches_tracked"):
            out[k] = torch.zeros((), dtype=torch.long, device=device)
    det = ref.model[-1]
    prefix = f"model.{len(ref.model) - 1}.m"
    spread = torch.randn(ref.nl, ref.na, nc, generator=g, device=device)
    for li, s in enumerate(ref.strides):
        b = torch.zeros(ref.na, det.no, device=device)
        b[:, 4] = math.log(8 / (640 / s) ** 2)
        b[:, 5:] = math.log(0.6 / (nc - 0.999999))
        b[:, 5:5 + nc] += CLASS_SPREAD * spread[li]
        out[f"{prefix}.{li}.bias"] = b.reshape(-1)
    missing = set(sd) - set(out)
    if missing:
        raise KeyError(f"no seeded value for {sorted(missing)[:4]}")
    return out


def shift_objectness(sd: dict, model_dict: dict, nc: int, delta: float):
    """Move every Detect objectness bias by ``delta`` in place."""
    ref = skeleton(model_dict, nc)
    prefix = f"model.{len(ref.model) - 1}.m"
    for li in range(ref.nl):
        sd[f"{prefix}.{li}.bias"].view(ref.na, -1)[:, 4] += delta


@torch.no_grad()
def quiet_batchnorm(sd: dict) -> None:
    """Scale every BatchNorm's weight, in ``sd``, by ``BN_GAIN``: each
    layer's normalised output then has that scale, where the SiLUs are
    near their linear part, and a rounding error does not grow layer by
    layer as it does at unit scale, where a random deep network is
    chaotic (a bf16 step's gradients then differ from float32's by 5-17%
    at the median leaf, seed to seed, as much as an fp8 step's)."""
    for k in sd:
        if k.endswith(".bn.weight"):
            sd[k].mul_(BN_GAIN)


@torch.no_grad()
def settle_batchnorm(sd: dict, model_dict: dict, nc: int, images) -> None:
    """Set every BatchNorm's running statistics, in ``sd``, to the batch
    statistics ``images`` give in a train-mode reference forward, as
    training leaves them: each layer's input is then centred (with
    identity statistics the activations shrink to their common part, and
    a rounding error of that part swamps what varies from cell to
    cell)."""
    ref = reference_model(model_dict, nc, sd, images.device).train()
    ref(images)
    for name, m in ref.named_modules():
        if getattr(m, "batch", None) is not None:
            sd[f"{name}.bn.running_mean"].copy_(m.batch[0])
            sd[f"{name}.bn.running_var"].copy_(m.batch[1])


@torch.no_grad()
def scale_head(sd: dict, model_dict: dict, nc: int, images) -> None:
    """Scale each Detect level's weights, in ``sd``, so that its outputs
    vary across the cells of ``images`` with unit standard deviation around
    the biases (the biases take back the mean the scaled weights add), as a
    trained head's logits do.  With random weights and running statistics
    at identity the activations shrink layer by layer (so errors shrink
    too: the forward is not chaotic), and the head's outputs would differ
    from cell to cell by less than one bf16 step of their value."""
    ref = reference_model(model_dict, nc, sd, images.device).eval()
    seen = {}
    det = ref.model[-1]
    det.register_forward_hook(lambda m, a, o: seen.__setitem__("in", a[0]))
    ref(images)
    prefix = f"model.{len(ref.model) - 1}.m"
    for li, (f, conv) in enumerate(zip(seen["in"], det.m)):
        y = torch.nn.functional.conv2d(f, conv.weight)
        gain = HEAD_SPREAD / float(y.std(dim=(2, 3)).mean())
        sd[f"{prefix}.{li}.weight"].mul_(gain)
        sd[f"{prefix}.{li}.bias"].sub_(gain * y.mean(dim=(0, 2, 3)))


def reference_model(model_dict: dict, nc: int, sd: dict, device):
    """A float32 reference model holding a copy of ``sd``."""
    ref = skeleton(model_dict, nc).to_empty(device=device)
    ref.load_state_dict(sd)
    return ref
