"""Train-mode BatchNorm + SiLU as one autograd Function
(``ops/kernels/bn_act_train.py``, ``csrc/bn_act_train.cu``).

On the CPU: ``models/layers._bn_act_chain``, the chain of PyTorch ops the
model runs off the card and the kernels' plain version, against the
closed forms the kernels compute (the four passes, the hand-derived
backward, no variance gradient where the variance clamps); the chain under
a stub data-parallel mesh whose sum doubles its argument, the one-rank
chain bit for bit; the wrapper's refusal of tensors the kernels do not
take; the counters of a CPU train step (every train-mode conv block
counted, none on the kernels).

On the card (``cuda``-marked; ``python -m pytest --noconftest -m cuda
tests/test_torch_port_bn_act.py``): the kernels against the chain at
yolov5m's 1024² b16 shapes and at odd ones, bit for bit on repeat, the
launches a call, the mesh's finalize modes, and a yolov5m train step's
counters.  The file imports no JAX."""

import contextlib
import types

import pytest
import torch

from yolov5_obb_tpu_torch.engine import trainer
from yolov5_obb_tpu_torch.engine.loss import ComputeLoss
from yolov5_obb_tpu_torch.engine.optim import build_optimizer
from yolov5_obb_tpu_torch.models import layers, step_context
from yolov5_obb_tpu_torch.models.yolo import create_model, load_config
from yolov5_obb_tpu_torch.ops.kernels import bn_act_train as K
from yolov5_obb_tpu_torch.utils import profiler
from yolov5_obb_tpu_torch.utils.general import load_hyp, scale_hyp_gains


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for the module, as the other port files."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def block(c, act=True, seed=0, device="cpu"):
    """What ``_bn_act_chain`` reads of a conv block: its BatchNorm, with
    random parameters and running statistics, in train mode, and ``act``."""
    g = torch.Generator().manual_seed(seed)
    bn = layers._bn_module(c)
    with torch.no_grad():
        bn.weight.copy_(torch.rand(c, generator=g) + 0.5)
        bn.bias.copy_(torch.randn(c, generator=g) * 0.2)
        bn.running_mean.copy_(torch.randn(c, generator=g))
        bn.running_var.copy_(torch.rand(c, generator=g) + 0.5)
    return types.SimpleNamespace(bn=bn.to(device).train(), act=act)


def clone(m):
    bn = layers._bn_module(m.bn.num_features).to(m.bn.weight.device)
    bn.load_state_dict(m.bn.state_dict())
    return types.SimpleNamespace(bn=bn.train(), act=m.act)


def inputs(shape, dtype, seed=1, device="cpu"):
    """A conv output with a channel-dependent mean and spread, and an
    incoming gradient."""
    g = torch.Generator().manual_seed(seed)
    c = shape[-1]
    z = torch.randn(shape, generator=g) * (torch.rand(c, generator=g) * 2
                                           + 0.2) + torch.randn(c, generator=g)
    dy = torch.randn(shape, generator=g)
    return z.to(device, dtype), dy.to(device, dtype)


def run(fn, m, z, dy):
    """``fn(m, z)``'s output, ``(dz, dw, db)`` for ``dy``, and the running
    statistics after it."""
    zz = z.clone().requires_grad_(True)
    y = fn(m, zz)
    dz, dw, db = torch.autograd.grad(y, (zz, m.bn.weight, m.bn.bias), dy)
    return {"y": y.detach(), "dz": dz, "dw": dw, "db": db,
            "running_mean": m.bn.running_mean.clone(),
            "running_var": m.bn.running_var.clone()}


def chain(m, z):
    return layers._bn_act_chain(m, z, z.dtype)


def kernels(m, z):
    return K.bn_act_train(m.bn, z, m.act)


def closed_form(m, z, dy):
    """What csrc/bn_act_train.cu computes, as float32 PyTorch ops: pass 1's
    ``(Σz, Σz²)`` and its finalize (mean, the biased variance clamped at 0,
    ``rstd``, the running statistics), pass 2's ``y``; pass 3's ``Σg`` and
    ``Σg·x̂`` with ``g = dy·σ(u)·(1 + u·(1 - σ(u)))`` (``db``, ``dw``) and
    pass 4's ``dz = w·rstd·(g - Σg/N - x̂·Σg·x̂/N)``, whose last term is 0
    where the variance clamped (the clamp passes no gradient)."""
    bn, c = m.bn, z.shape[-1]
    z2, dy2 = z.reshape(-1, c).float(), dy.reshape(-1, c).float()
    n = z2.shape[0]
    mean = z2.sum(0) / n
    raw = (z2 * z2).sum(0) / n - mean * mean
    var = torch.clamp(raw, min=0.0)
    rstd = torch.rsqrt(var + layers.BN_EPS)
    w, b = bn.weight.detach(), bn.bias.detach()
    xh = (z2 - mean) * rstd
    u = (z2 - mean) * (rstd * w) + b
    s = torch.sigmoid(u)
    y, g = (u * s, dy2 * s * (1 + u * (1 - s))) if m.act else (u, dy2)
    sg, sgx = g.sum(0), (g * xh).sum(0)
    dz = (rstd * w) * (g - sg / n - xh * (sgx / n) * (raw >= 0))
    return {"y": y.to(z.dtype).view(z.shape), "dz": dz.to(z.dtype).view(
        z.shape), "dw": sgx, "db": sg,
            "running_mean": 0.97 * bn.running_mean + 0.03 * mean,
            "running_var": 0.97 * bn.running_var + 0.03 * var}


def close(got, want, dtype):
    """Within float32 rounding (of terms as large as the tensor's largest
    element: ``dz``'s three terms cancel); an output rounded to bfloat16
    within one bfloat16 ulp (a float32 difference can move a rounding)."""
    for k in ("dw", "db", "running_mean", "running_var"):
        torch.testing.assert_close(got[k], want[k], rtol=2e-5, atol=2e-6,
                                   msg=k)
    for k in ("y", "dz"):
        a, b = got[k].float(), want[k].float()
        tol = (dict(rtol=1e-5, atol=1e-5 * float(b.abs().max()))
               if dtype == torch.float32 else dict(rtol=2 ** -7, atol=1e-6))
        torch.testing.assert_close(a, b, **tol, msg=k)


SHAPES = [(2, 5, 7, 16), (2, 6, 5, 13), (3, 4, 4, 40)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("act", [True, False])
def test_chain_matches_closed_form(dtype, shape, act):
    m = block(shape[-1], act)
    z, dy = inputs(shape, dtype)
    close(run(chain, clone(m), z, dy), closed_form(clone(m), z, dy), dtype)


def test_chain_clamped_variance():
    """A constant channel: E[z²] - E[z]² rounds below 0 and clamps, in the
    chain and in the closed form; both stay finite and agree there (the
    variance's gradient term, which the clamp drops, is below float32
    rounding at so small a spread).  The kernels hold the same case on the
    card."""
    m = block(4)
    z, dy = inputs((2, 3, 3, 4), torch.float32)
    z[..., 1] = 0.1
    mean = z.mean((0, 1, 2))
    assert float((z * z).mean((0, 1, 2))[1] - mean[1] ** 2) < 0  # clamps
    close(run(chain, clone(m), z, dy), closed_form(clone(m), z, dy),
          torch.float32)


class StubMesh:
    """Two ranks that hold the same batch: a sum doubles its argument (the
    chain's differentiable ``sum``, the Function's in-place ``sum_``)."""

    world = 2

    def __init__(self):
        self.calls = 0

    def sum(self, t):
        self.calls += 1
        return t * 2

    def sum_(self, t):
        self.calls += 1
        return t.mul_(2)


@contextlib.contextmanager
def mesh_step(mesh):
    with step_context.train_step(mesh, None):
        yield


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_chain_mesh_sums(dtype):
    """Under two ranks holding the same batch the chain's global statistics
    and input gradient are the one-rank ones, bit for bit (the sum doubles
    the moments it weights by 1/2; its backward doubles their gradient);
    a sum left out would halve the mean.  ``dw``, ``db`` stay the rank's
    own.  The kernels' two sums are held to the same on the card."""
    m = block(16)
    z, dy = inputs((2, 5, 7, 16), dtype)
    alone = run(chain, clone(m), z, dy)
    mesh = StubMesh()
    with mesh_step(mesh):
        got = run(chain, clone(m), z, dy)
    assert mesh.calls == 1
    for k, v in alone.items():
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("case,why", [
    ("cpu", "not a CUDA device"), ("float16", "not bfloat16 or float32"),
    ("empty", "z empty"), ("float64_stats", "running_var in torch.float64")])
def test_kernels_refuse_what_they_do_not_take(case, why):
    """The wrapper raises before any launch; ``_bn_act`` sends it every
    train-mode float32 BatchNorm on the card, so a tensor the kernels do
    not take fails loudly there instead of running the chain."""
    m = block(8)
    z, _ = inputs((1, 2, 2, 8), torch.bfloat16)
    if case == "float16":
        z = z.half()
    elif case == "empty":
        z = z[:0]
    elif case == "float64_stats":
        m.bn.running_var.data = m.bn.running_var.double()
    with pytest.raises(ValueError, match=why):
        K.bn_act_train(m.bn, z, m.act)


def small_model(device="cpu", dtype=torch.float32):
    cfg = load_config("yolov5m.yaml")
    cfg.update(width_multiple=0.25, depth_multiple=0.33)
    return create_model(cfg, nc=15, device=device, seed=1, dtype=dtype)


def one_step(model, meta, device, S=64, B=2):
    hyp = load_hyp()
    loss_fn = ComputeLoss(meta, scale_hyp_gains(hyp, meta.nl, meta.nc, S))
    opt, _ = build_optimizer(model, hyp, epochs=1, steps_per_epoch=10,
                             batch_size=B, nominal_batch=B)
    state = trainer.create_train_state(opt)
    step = trainer.make_train_step(model, loss_fn, opt, device=device)
    g = torch.Generator().manual_seed(0)
    img = torch.randint(0, 256, (B, S, S, 3), generator=g, dtype=torch.uint8)
    if model.packed_stem:
        img = img.view(B, S, 3 * S)
    tg = torch.zeros(B, 4, 186)
    tg[:, 0, 1:6] = torch.tensor([S / 2, S / 2, S / 3, S / 6, 0.3])
    mask = torch.zeros(B, 4, dtype=torch.bool)
    mask[:, 0] = True
    blocks = [0]

    def hook(mod, args, out):
        blocks[0] += mod.training

    hooks = [mod.register_forward_hook(hook) for mod in model.modules()
             if isinstance(mod, layers.ConvBnAct)]
    before = profiler.counters()
    try:
        metrics = step(state, img, tg, mask)
    finally:
        for h in hooks:
            h.remove()
    after = profiler.counters()
    return blocks[0], {k: after[k] - before[k]
                       for k in ("bn_act.calls", "bn_act.fused")}, metrics


def test_cpu_train_step_counts_every_block_and_no_kernel():
    model, meta = small_model()
    blocks, counted, metrics = one_step(model, meta, "cpu")
    assert blocks > 0
    assert counted == {"bn_act.calls": blocks, "bn_act.fused": 0}
    assert torch.isfinite(metrics["loss"])


def test_eval_and_plain_calls_are_not_fused():
    """Eval mode is not counted; ``plain`` is counted and keeps the
    chain."""
    m = block(8)
    z, _ = inputs((1, 2, 2, 8), torch.float32)
    before = profiler.counters()
    layers._bn_act(m, z, z.dtype, plain=True)
    m.bn.eval()
    layers._bn_act(m, z, z.dtype)
    after = profiler.counters()
    assert after["bn_act.calls"] - before["bn_act.calls"] == 1
    assert after["bn_act.fused"] == before["bn_act.fused"]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

# yolov5m's train-mode BatchNorm outputs at b16 1024² (width 0.75): the
# stem's, the layer-1 downsample's, a C3's at 256², the deepest
CARD_SHAPES = [(16, 512, 512, 48), (16, 256, 256, 96), (16, 256, 256, 48),
               (16, 32, 32, 768)]
ODD_SHAPES = [(3, 17, 9, 13), (2, 33, 7, 1288), (5, 3, 1, 8)]
# the share of y and dz elements the kernels may put over one bfloat16 ulp
# from the chain: measured on the card at most 2.5e-4 of y's elements and
# 1.4e-5 of dz's (a summation order moves the batch mean's rounding)
OVER_ULP = {"y": 1e-3, "dz": 1e-4}


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernels are CUDA)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def ulps(got, want):
    """Per element: |got - want| in units of bfloat16's spacing at want."""
    w = want.float()
    spacing = torch.ldexp(torch.ones_like(w),
                          torch.frexp(w).exponent - 8).clamp(min=2.0 ** -133)
    return (got.float() - w).abs() / spacing


def card_close(got, want, dtype):
    """``dw``, ``db`` and the running statistics to float32 rounding of
    their sums; ``y`` and ``dz`` within one bfloat16 ulp (float32 outputs:
    float32 rounding) in all but ``OVER_ULP`` of the elements."""
    for k in ("dw", "db", "running_mean", "running_var"):
        err = float((got[k] - want[k]).norm() / want[k].norm())
        assert err <= 1e-4, (k, err)
    shares = {}
    for k in ("y", "dz"):
        if dtype == torch.bfloat16:
            shares[k] = float((ulps(got[k], want[k]) > 1).float().mean())
        else:
            tol = 1e-5 * want[k].abs() + 1e-5 * want[k].abs().max()
            shares[k] = float(((got[k] - want[k]).abs() > tol).float().mean())
        assert shares[k] <= OVER_ULP[k], (k, shares)
    return shares


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES + ODD_SHAPES)
def test_kernels_match_chain_on_card(dev, shape):
    m = block(shape[-1], device=dev)
    z, dy = inputs(shape, torch.bfloat16, device=dev)
    got = run(kernels, clone(m), z, dy)
    want = run(chain, clone(m), z, dy)
    print("over one ulp", shape, card_close(got, want, torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 9, 11, 24), (3, 5, 7, 13)])
@pytest.mark.parametrize("act", [True, False])
def test_kernels_float32_and_identity_on_card(dev, shape, act):
    for dtype in (torch.float32, torch.bfloat16):
        m = block(shape[-1], act, device=dev)
        z, dy = inputs(shape, dtype, device=dev)
        card_close(run(kernels, clone(m), z, dy),
                   run(chain, clone(m), z, dy), dtype)


@pytest.mark.cuda
def test_kernels_clamped_variance_on_card(dev):
    """The CPU case of a constant channel, whose variance clamps: the
    kernels finite and within the chain's rounding."""
    m = block(4, device=dev)
    z, dy = inputs((2, 3, 3, 4), torch.float32)
    z[..., 1] = 0.1
    z, dy = z.to(dev), dy.to(dev)
    got = run(kernels, clone(m), z, dy)
    assert all(bool(torch.isfinite(v).all()) for v in got.values())
    card_close(got, run(chain, clone(m), z, dy), torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 256, 256, 96), (3, 17, 9, 13)])
def test_kernels_repeat_bit_for_bit_in_six_launches(dev, shape):
    m = block(shape[-1], device=dev)
    z, dy = inputs(shape, torch.bfloat16, device=dev)
    before = {n: k.launches for n, k in K.KERNELS.items()}
    a = run(kernels, clone(m), z, dy)
    launches = {n: k.launches - before[n] for n, k in K.KERNELS.items()}
    assert launches == {n: 1 for n in K.KERNELS}, launches
    b = run(kernels, clone(m), z, dy)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.cuda
def test_kernels_mesh_modes_on_card(dev):
    """Under the stub mesh the finalizes run in two launches around each
    sum: the one-rank values bit for bit, eight launches a call."""
    m = block(96, device=dev)
    z, dy = inputs((4, 64, 64, 96), torch.bfloat16, device=dev)
    alone = run(kernels, clone(m), z, dy)
    mesh = StubMesh()
    before = sum(k.launches for k in K.KERNELS.values())
    with mesh_step(mesh):
        got = run(kernels, clone(m), z, dy)
    assert sum(k.launches for k in K.KERNELS.values()) - before == 8
    assert mesh.calls == 2
    for k, v in alone.items():
        assert torch.equal(got[k], v), k


@pytest.mark.cuda
def test_train_step_takes_the_kernels_on_card(dev):
    """yolov5m as the train cells build it (bf16, the packed stem)."""
    model, meta = create_model("yolov5m.yaml", nc=15, dtype=torch.bfloat16,
                               device=dev, packed_stem=True)
    blocks, counted, metrics = one_step(model, meta, dev, S=256)
    assert blocks > 0
    assert counted == {"bn_act.calls": blocks, "bn_act.fused": blocks}
    assert torch.isfinite(metrics["loss"])
