"""The rest of the layer zoo and the activations against the JAX package's,
on the CPU, layer by layer: the same numpy-seeded inputs and weights
(``utils/weights`` carries the flax trees across) through each JAX module
and its port counterpart.

Float32 in eval mode and in train mode (BatchNorm's batch statistics and
the running-statistic update) at ``atol = rtol = 1e-5`` (where the JAX
float32 output is itself further than that from its float64 run, within
8x that distance); bfloat16 in eval
mode within one bf16 ulp of the output's scale (``2^(floor(log2 max|y|) -
7)``).  The JAX modules run eagerly, one primitive at a time, as the port's
ops do.  The ``--bn-half`` sites (BottleneckCSP, both CrossConv convs,
MixConv2d) run in train mode under ``YOLO_BN_HALF=1`` against a JAX
reference computed in a process of its own, this file run as a script,
with XLA's excess precision off (as ``tests/test_torch_port_bn_half.py``
does).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from yolov5_obb_tpu_torch.models import activations as PA
from yolov5_obb_tpu_torch.models import layers as PL
from yolov5_obb_tpu_torch.models.yolo import LayerSpec, _build_module
from yolov5_obb_tpu_torch.utils import weights as W

ROOT = Path(__file__).resolve().parents[1]
B, S = 2, 16

# name → (JAX module kind, args as parse_model_config gives them, input
# channels or a list of them for a multi-input layer)
LAYERS = {
    "BottleneckCSP": ("BottleneckCSP", (16, 32, 2), 16),
    "BottleneckCSP_noshortcut": ("BottleneckCSP", (32, 32, 1, False), 32),
    "SPP": ("SPP", (32, 24, (5, 9, 13)), 32),
    "C3SPP": ("C3SPP", (32, 32), 32),
    "C3TR": ("C3TR", (32, 32, 2), 32),
    "Focus": ("Focus", (3, 32, 3), 3),
    "CrossConv": ("CrossConv", (16, 32, 3, 2), 16),
    "CrossConv_shortcut": ("CrossConv", (32, 32, 3, 1, 2, 1.0, True), 32),
    "MixConv2d": ("MixConv2d", (16, 32, (1, 3, 5)), 16),
    "MixConv2d_s2": ("MixConv2d", (16, 24, (3, 5), 2), 16),
    "Contract": ("Contract", (2,), 24),
    "Expand": ("Expand", (2,), 32),
    "Sum": ("Sum", (2,), [24, 24]),
    "Sum_weighted": ("Sum", (3, True), [24, 24, 24]),
    "Classify": ("Classify", (32, 10), 32),
    "MaxPool": ("MaxPool", (2,), 16),
    "MaxPool_k3s2": ("MaxPool", (3, 2), 16),
}
HAS_BN = {"BottleneckCSP", "SPP", "C3SPP", "C3TR", "Focus", "CrossConv",
          "MixConv2d"}
BN_HALF = ("BottleneckCSP", "CrossConv", "CrossConv_shortcut", "MixConv2d")


# ---------------------------------------------------------------------------
# both sides of a layer
# ---------------------------------------------------------------------------


def _jax_module(kind, args, dtype):
    import jax.numpy as jnp

    from yolov5_obb_tpu.models import layers as JL

    dt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    if kind in ("Sum", "Contract", "Expand"):
        return getattr(JL, kind)(*args)
    if kind == "MaxPool":
        return JL.MaxPool(*args)
    if kind == "TransformerBlock":
        return JL.TransformerBlock(*args, dtype=dt)
    return getattr(JL, kind)(*args, dtype=dt)


def _fill(seed):
    """numpy-seeded values for every leaf of a flax tree."""
    rng = np.random.default_rng(seed)

    def fill_one(path, sd):
        name = path[-1].key
        shape = sd.shape
        if name == "kernel":
            if len(shape) == 3:  # attention (c, h, d) in, (h, d, c) out
                fan_in = np.prod(shape[:2]) if path[-2].key == "out" \
                    else shape[0]
            else:
                fan_in = np.prod(shape[:-1])
            return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(
                np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 2.0, shape).astype(np.float32)
        if name in ("w", "p1", "p2"):
            return rng.normal(0.0, 1.0, shape).astype(np.float32)
        if name == "beta":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return rng.normal(0.0, 0.1, shape).astype(np.float32)
    return fill_one


def _inputs(cin, seed=1, s=S):
    rng = np.random.default_rng(seed)
    if isinstance(cin, list):
        return [rng.normal(0, 1, (B, s, s, c)).astype(np.float32)
                for c in cin]
    return rng.normal(0, 1, (B, s, s, cin)).astype(np.float32)


def _jax_vars(mod, x, seed=0):
    import jax
    import jax.numpy as jnp

    xj = [jnp.asarray(a) for a in x] if isinstance(x, list) \
        else jnp.asarray(x)
    shapes = jax.eval_shape(mod.init, jax.random.PRNGKey(0), xj)
    return jax.tree.map(np.asarray, dict(
        jax.tree_util.tree_map_with_path(_fill(seed), shapes)))


def _jax_apply(mod, v, x, dtype, train):
    """Eager JAX forward: the output (float32 numpy) and, in train mode,
    the updated batch statistics."""
    import jax.numpy as jnp

    dt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    xj = [jnp.asarray(a, dt) for a in x] if isinstance(x, list) \
        else jnp.asarray(x, dt)
    if train and "batch_stats" in v:
        y, mut = mod.apply(v, xj, train=True, mutable=["batch_stats"])
        stats = jax_tree_np(mut["batch_stats"])
    else:
        y, stats = mod.apply(v, xj, train=train), None
    return np.asarray(jnp.asarray(y, jnp.float32)), stats


def _jax_apply64(mod, v, x, train):
    """The float32 JAX module's forward in float64 (module, weights and
    input), for the float32 reference's own rounding error."""
    import jax
    import jax.numpy as jnp

    with jax.enable_x64(True):
        m64 = mod.clone(dtype=jnp.float64)
        v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), v)
        y = m64.apply(v64, jnp.asarray(x, jnp.float64), train=train,
                      mutable=["batch_stats"])[0]
        return np.asarray(y)


def jax_tree_np(t):
    import jax

    return jax.tree.map(np.asarray, dict(t))


def _port_layer(kind, args, v, dtype=torch.float32):
    """The port's layer as the model builds it, with the JAX tree's
    weights."""
    m = _build_module(LayerSpec(1, -1, 1, kind, args), False, dtype)
    entries = W._module_entries(kind, args, None, "", ())
    sd = W._to_torch(v, entries)
    m.load_state_dict(sd, strict=True)
    return m


def _port_apply(m, x, dtype, train):
    xt = [torch.from_numpy(a).to(dtype) for a in x] if isinstance(x, list) \
        else torch.from_numpy(x).to(dtype)
    m.train(train)
    with torch.no_grad():
        y = m(xt)
    m.eval()
    return y.float().numpy()


def _ulp(scale):
    return 2.0 ** (np.floor(np.log2(scale)) - 7)


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["f32_eval", "f32_train", "bf16_eval"])
@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_matches_jax(name, mode):
    kind, args, cin = LAYERS[name]
    dtype = torch.bfloat16 if mode.startswith("bf16") else torch.float32
    train = mode.endswith("train")
    x = _inputs(cin)
    jm = _jax_module(kind, args, dtype)
    v = _jax_vars(jm, x)
    want, stats = _jax_apply(jm, v, x, dtype, train)
    m = _port_layer(kind, args, v, dtype)
    got = _port_apply(m, x, dtype, train)
    assert got.shape == want.shape
    if dtype == torch.float32 and not np.allclose(got, want, rtol=1e-5,
                                                  atol=1e-5):
        # behind SPP's pooled features train-mode BatchNorm divides by a
        # batch deviation ~10x below the mean, and float32 itself misses
        # 1e-5 (SPP's JAX output is 1.3e-5 from its float64 run; the
        # port's convs and normalisation round a few ulps apart, measured
        # 5.5x that, C3SPP 3.3x): hold the port to 8x the JAX float32
        # output's own distance, in train mode only
        noise = np.abs(want - _jax_apply64(jm, v, x, train)).max()
        assert train, "eval mode holds 1e-5"
        assert np.abs(got - want).max() <= 8 * noise, (
            np.abs(got - want).max(), noise)
    elif dtype == torch.bfloat16:
        err = np.abs(got - want).max()
        assert err <= _ulp(np.abs(want).max()), (err, np.abs(want).max())
    if train and kind in HAS_BN:
        assert stats is not None
        entries = W._module_entries(kind, args, None, "", ())
        sd = W._to_torch({"params": v["params"], "batch_stats": stats},
                         entries)
        before = W._to_torch(v, entries)
        moved = 0
        for k, t in m.state_dict().items():
            if "running" in k:
                np.testing.assert_allclose(t.numpy(), sd[k].numpy(),
                                           rtol=1e-5, atol=1e-6, err_msg=k)
                moved += not torch.equal(t, before[k])
        assert moved > 0  # the running statistics were updated


def test_transformer_block_with_a_conv_matches_jax():
    """TransformerBlock(c1 != c2): the 1x1 ConvBnAct first, then the
    position linear and two layers; the weight map's ``conv`` branch."""
    jm = _jax_module("TransformerBlock", (16, 32, 4, 2), torch.float32)
    x = _inputs(16)
    v = _jax_vars(jm, x)
    want, _ = _jax_apply(jm, v, x, torch.float32, False)
    m = PL.TransformerBlock(16, 32, 4, 2)
    m.load_state_dict(W._to_torch(v, W._transformer_block("", (), 2, True)))
    np.testing.assert_allclose(_port_apply(m, x, torch.float32, False), want,
                               rtol=1e-5, atol=1e-5)


def test_attention_is_explicit_products():
    """The attention is the flax formula written out: the port's output
    equals softmax(q kᵀ / sqrt(d)) v per head through the projections,
    and a C3TR never takes the C3 kernel."""
    torch.manual_seed(0)
    ma = PL.MultiHeadAttention(16, 4)
    q, k, v = (torch.randn(2, 9, 16) for _ in range(3))
    Q = ma.query(q).view(2, 9, 4, 4).transpose(1, 2)
    K = ma.key(k).view(2, 9, 4, 4).transpose(1, 2)
    V = ma.value(v).view(2, 9, 4, 4).transpose(1, 2)
    a = torch.softmax(Q @ K.transpose(-1, -2) / 2.0, -1) @ V
    want = ma.out(a.transpose(1, 2).reshape(2, 9, 16))
    torch.testing.assert_close(ma(q, k, v), want, rtol=1e-5, atol=1e-6)
    c3tr = PL.C3TR(32, 32, 1)
    assert not c3tr.fused and not c3tr.eligible(torch.zeros(1, 512, 512, 32))


# ---------------------------------------------------------------------------
# the activations
# ---------------------------------------------------------------------------


def _act_entries(name):
    if name == "FReLU":
        return [("conv.weight", ("params", "Conv_0", "kernel"), "conv"),
                *W._bn("bn.", ("BatchNorm_0",))]
    out = [(p, ("params", p), "raw") for p in ("p1", "p2")]
    if name == "AconC":
        return out + [("beta", ("params", "beta"), "raw")]
    return out + [
        ("fc1.weight", ("params", "Conv_0", "kernel"), "conv"),
        ("fc1.bias", ("params", "Conv_0", "bias"), "vec"),
        ("fc2.weight", ("params", "Conv_1", "kernel"), "conv"),
        ("fc2.bias", ("params", "Conv_1", "bias"), "vec")]


def _act_state(v, name):
    sd = {}
    for key, path, kind in _act_entries(name):
        if kind == "raw":
            sd[key] = torch.from_numpy(np.array(v["params"][path[-1]]))
        else:
            sd.update(W._to_torch(v, [(key, path, kind)]))
    return sd


ACT_MODULES = {"FReLU": (16,), "AconC": (16,), "MetaAconC": (32, 1, 1, 4)}


@pytest.mark.parametrize("mode", ["f32_eval", "f32_train", "bf16_eval"])
@pytest.mark.parametrize("name", ["hardswish", "mish", "silu", "FReLU",
                                  "AconC", "MetaAconC"])
def test_activation_matches_jax(name, mode):
    """Each activation of ``models/activations.py``: the functions on a
    wide range of inputs (|x| up to 30, past torch softplus's linear
    threshold), the modules with their parameters carried across."""
    import jax.numpy as jnp

    from yolov5_obb_tpu.models import activations as JA

    dtype = torch.bfloat16 if mode.startswith("bf16") else torch.float32
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    train = mode.endswith("train")
    if name in ACT_MODULES:
        args = ACT_MODULES[name]
        x = _inputs(args[0], seed=3)
        jm = getattr(JA, name)(*args)
        v = _jax_vars(jm, x, seed=4)
        want, stats = _jax_apply(jm, v, x, dtype, train)
        m = getattr(PA, name)(*args)
        m.load_state_dict(_act_state(v, name))
        got = _port_apply(m, x, dtype, train)
        if stats is not None:
            sd = W._to_torch({"params": v["params"], "batch_stats": stats},
                             W._bn("bn.", ("BatchNorm_0",)))
            for k in ("bn.running_mean", "bn.running_var"):
                np.testing.assert_allclose(m.state_dict()[k].numpy(),
                                           sd[k].numpy(), rtol=1e-5,
                                           atol=1e-6)
    else:
        x = np.random.default_rng(5).uniform(-30, 30, (B, S, S, 8)).astype(
            np.float32)
        want = np.asarray(jnp.asarray(getattr(JA, name)(jnp.asarray(x, jdt)),
                                      jnp.float32))
        with torch.no_grad():
            got = getattr(PA, name)(torch.from_numpy(x).to(dtype)).float()
        got = got.numpy()
        mod = {"hardswish": PA.Hardswish, "mish": PA.Mish}.get(name)
        if mod is not None:
            with torch.no_grad():
                assert torch.equal(mod()(torch.from_numpy(x).to(dtype)),
                                   getattr(PA, name)(
                                       torch.from_numpy(x).to(dtype)))
    assert got.shape == want.shape
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        err = np.abs(got - want).max()
        assert err <= _ulp(np.abs(want).max()), (err, np.abs(want).max())


# ---------------------------------------------------------------------------
# the --bn-half sites
# ---------------------------------------------------------------------------


def _reference_main(out):
    """The bn-half sites' JAX train-mode forwards (bf16, YOLO_BN_HALF=1,
    jitted): outputs and updated batch statistics, saved to ``out``."""
    import jax
    from flax.traverse_util import flatten_dict

    arrays = {}
    for name in BN_HALF:
        kind, args, cin = LAYERS[name]
        x = _inputs(cin)
        jm = _jax_module(kind, args, torch.bfloat16)
        v = _jax_vars(jm, x)
        y, stats = jax.jit(lambda v, x, jm=jm: _jit_train(jm, v, x))(v, x)
        arrays[f"{name}/out"] = np.asarray(y, np.float32)
        for k, t in flatten_dict(jax.tree.map(np.asarray, stats)).items():
            arrays[f"{name}/stat/" + "/".join(k)] = np.asarray(t)
    np.savez(out, **arrays)


def _jit_train(jm, v, x):
    import jax.numpy as jnp

    y, mut = jm.apply(v, jnp.asarray(x, jnp.bfloat16), train=True,
                      mutable=["batch_stats"])
    return y.astype(jnp.float32), mut["batch_stats"]


@pytest.fixture(scope="module")
def bn_half_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("zoo") / "bn_half.npz"
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT), str(ROOT / "tests"),
         *filter(None, [os.environ.get("PYTHONPATH")])])
    proc = subprocess.run([sys.executable, __file__, str(out)], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(out))


@pytest.mark.parametrize("name", BN_HALF)
def test_bn_half_site_matches_jax(name, bn_half_ref, monkeypatch):
    """Train mode, bf16, under YOLO_BN_HALF=1: the BatchNorm output cast
    to bf16 and SiLU in bf16, as the JAX layer does (its BN with
    ``dtype=_bn_dtype(train)``): the output within one bf16 ulp of its
    scale, the running statistics within 1e-5 of theirs; without the flag
    the port's output differs."""
    from flax.traverse_util import unflatten_dict

    kind, args, cin = LAYERS[name]
    x = _inputs(cin)
    jm = _jax_module(kind, args, torch.bfloat16)
    v = _jax_vars(jm, x)
    want = bn_half_ref[f"{name}/out"]
    pre = f"{name}/stat/"
    stats = unflatten_dict({tuple(k[len(pre):].split("/")): t
                            for k, t in bn_half_ref.items()
                            if k.startswith(pre)})
    entries = W._module_entries(kind, args, None, "", ())
    ref_sd = W._to_torch({"params": v["params"], "batch_stats": stats},
                         entries)
    outs = {}
    for flag in ("1", "0"):
        monkeypatch.setenv("YOLO_BN_HALF", flag)
        m = _port_layer(kind, args, v, torch.bfloat16)
        outs[flag] = _port_apply(m, x, torch.bfloat16, True)
        if flag == "1":
            for k, t in m.state_dict().items():
                if "running" in k:
                    scale = max(np.abs(ref_sd[k].numpy()).max(), 1.0)
                    assert np.abs(t.numpy() - ref_sd[k].numpy()).max() \
                        <= 1e-5 * scale, k
    err = np.abs(outs["1"] - want).max()
    assert err <= _ulp(np.abs(want).max()), (err, np.abs(want).max())
    assert not np.array_equal(outs["0"], outs["1"])


if __name__ == "__main__":
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["YOLO_BN_HALF"] = "1"
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_allow_excess_precision=false")
    os.environ.pop("JAX_COMPILATION_CACHE_DIR", None)
    _reference_main(sys.argv[1])
