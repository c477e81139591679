"""The port's vision layers and Table VI arithmetic against the JAX
package's, on the CPU.

``im2col``, ``conv2d_q`` (1 x 1 and 3 x 3, stride 1 and 2, pad 0 and 1;
float, integer and weight-only on raw weights, integer on PackedWeight
leaves), ``depthwise_conv_q`` and ``bn_relu`` on the same numpy inputs,
each output within 1e-5 of its largest |value| (im2col bit for bit:
it only copies).  The reference runs its oracle matmul
(``use_kernel=False``) on raw weights and, as it does for a PackedWeight
leaf, its Pallas kernel in interpret mode, at K <= 256 where that kernel
holds its oracle (ROADMAP queue 3).  ``mobilenet_macs`` and
``model_bytes`` of the full-size networks equal the reference's
integers in every Table VI format; the specs match the reference's
shapes, inits and quantize flags; the weight bridge's round trip is
bit-exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quant import QuantConfig as JaxQuant
from repro.kernels.ops import PackedWeight as JaxPacked
from repro.kernels.ops import prepare_weight as jax_prepare
from repro.models import vision as JV
from repro_torch.core.quant import QuantConfig
from repro_torch.kernels.ops import PackedWeight, prepare_weight
from repro_torch.models import vision as V
from repro_torch.weights import vision_from_jax_numpy, vision_to_jax_numpy

# (kernel, stride, pad)
GEOMS = [(1, 1, 0), (1, 2, 0), (3, 1, 1), (3, 2, 1), (3, 1, 0), (3, 2, 0)]
# (mode, a_bits, w_bits) of the raw-weight conv cases; None is float
RAW_FMTS = {"fp": None, "a8w8": ("int", 8, 8), "a4w2": ("int", 4, 2),
            "wo_w4": ("wo", 8, 4)}


def _rng(seed):
    return np.random.RandomState(seed)


def _close(got, want, tol=1e-5):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


def _quants(fmt):
    if fmt is None:
        return None, None
    mode, a, w = fmt
    return (JaxQuant(mode=mode, a_bits=a, w_bits=w, use_kernel=False),
            QuantConfig(mode=mode, a_bits=a, w_bits=w))


@pytest.mark.parametrize("k,stride,pad", GEOMS)
def test_im2col_matches_reference(k, stride, pad):
    x = _rng(0).randn(2, 9, 7, 5).astype(np.float32)
    want = np.asarray(JV.im2col(jnp.asarray(x), k, k, stride, pad))
    got = V.im2col(torch.from_numpy(x), k, k, stride, pad)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("fmt", sorted(RAW_FMTS))
@pytest.mark.parametrize("k,stride,pad", GEOMS)
def test_conv2d_q_raw_weight_matches_reference(k, stride, pad, fmt):
    rng = _rng(1)
    x = rng.randn(2, 8, 8, 6).astype(np.float32)
    w = (rng.randn(k, k, 6, 20) / np.sqrt(k * k * 6)).astype(np.float32)
    jq, tq = _quants(RAW_FMTS[fmt])
    want = JV.conv2d_q(jnp.asarray(x), jnp.asarray(w), jq, stride, pad)
    got = V.conv2d_q(torch.from_numpy(x), torch.from_numpy(w), tq, stride,
                     pad)
    _close(got, want)


@pytest.mark.parametrize("a_bits,w_bits", [(8, 8), (8, 4), (4, 2)])
@pytest.mark.parametrize("k,stride,pad", [(1, 1, 0), (3, 2, 1)])
def test_conv2d_q_packed_weight_matches_reference(k, stride, pad, a_bits,
                                                  w_bits):
    """A PackedWeight leaf of the flattened weight: the kernel size is
    read from its K (3 from K = 27 at the stem's cin 3)."""
    rng = _rng(2)
    x = rng.randn(2, 8, 8, 3).astype(np.float32)
    w = (rng.randn(k * k * 3, 16) / np.sqrt(k * k * 3)).astype(np.float32)
    jq = JaxQuant(mode="int", a_bits=a_bits, w_bits=w_bits)
    tq = QuantConfig(mode="int", a_bits=a_bits, w_bits=w_bits)
    jpw, tpw = jax_prepare(jnp.asarray(w), jq), prepare_weight(
        torch.from_numpy(w), tq)
    np.testing.assert_array_equal(tpw.packed.numpy(), np.asarray(jpw.packed))
    want = JV.conv2d_q(jnp.asarray(x), jpw, jq, stride, pad)
    got = V.conv2d_q(torch.from_numpy(x), tpw, tq, stride, pad)
    _close(got, want)


def test_packed_weight_needs_an_int_or_wo_format():
    pw = prepare_weight(torch.ones(27, 4), QuantConfig(mode="int"))
    for quant in (None, QuantConfig(mode="bf16")):
        with pytest.raises(ValueError, match="int/wo"):
            V.conv2d_q(torch.ones(1, 4, 4, 3), pw, quant)


@pytest.mark.parametrize("stride", [1, 2])
def test_depthwise_conv_q_matches_reference(stride):
    rng = _rng(3)
    x = rng.randn(2, 10, 10, 6).astype(np.float32)
    w = (0.3 * rng.randn(3, 3, 6)).astype(np.float32)
    want = JV.depthwise_conv_q(jnp.asarray(x), jnp.asarray(w), stride, 1)
    _close(V.depthwise_conv_q(torch.from_numpy(x), torch.from_numpy(w),
                              stride, 1), want)


@pytest.mark.parametrize("relu", [True, False])
def test_bn_relu_matches_reference(relu):
    rng = _rng(4)
    x, s, b = (rng.randn(2, 4, 4, 6).astype(np.float32),
               rng.randn(6).astype(np.float32),
               rng.randn(6).astype(np.float32))
    want = JV.bn_relu(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), relu)
    _close(V.bn_relu(*map(torch.from_numpy, (x, s, b)), relu), want)


SPECS = {"mobilenet": (JV.mobilenet_specs, V.mobilenet_specs),
         "resnet": (JV.resnet20_specs, V.resnet20_specs)}


@pytest.mark.parametrize("net", sorted(SPECS))
def test_specs_match_reference(net):
    for kw in ({}, {"base": 8, "n_classes": 10}):
        js, ts = SPECS[net][0](**kw), SPECS[net][1](**kw)
        assert list(js) == list(ts)
        for k in js:
            assert (ts[k].shape, ts[k].init, ts[k].scale, ts[k].quantize) \
                == (js[k].shape, js[k].init, js[k].scale, js[k].quantize), k
            if ts[k].init == "normal":
                std = js[k].scale or js[k].fan_in() ** -0.5
                assert ts[k].std() == pytest.approx(std, rel=1e-12), k


def test_mobilenet_macs_match_reference():
    for kw in ({}, {"base": 8, "img": 32}, {"base": 16, "img": 96}):
        assert V.mobilenet_macs(**kw) == JV.mobilenet_macs(**kw)


# Table VI's formats: (mode, w_bits); None is float32
BYTES_FMTS = {"fp32": None, "8b": ("int", 8), "8b4b": ("int", 4),
              "4b2b": ("int", 2), "wo_w4": ("wo", 4), "bf16": ("bf16", 8)}


@pytest.mark.parametrize("fmt", sorted(BYTES_FMTS))
@pytest.mark.parametrize("net", sorted(SPECS))
def test_model_bytes_match_reference(net, fmt):
    f = BYTES_FMTS[fmt]
    jq = None if f is None else JaxQuant(mode=f[0], w_bits=f[1])
    tq = None if f is None else QuantConfig(mode=f[0], w_bits=f[1])
    want = JV.model_bytes(SPECS[net][0](), jq)
    assert V.model_bytes(SPECS[net][1](), tq) == want


def test_table6_memory_savings():
    """The paper's 47% (MobileNetV1 8b4b against 8b) and 63%-class
    (ResNet-20 4b2b against 8b) savings, from the port's arithmetic."""
    ms, rs = V.mobilenet_specs(), V.resnet20_specs()
    b8, b4 = (V.model_bytes(ms, QuantConfig(mode="int", w_bits=w))
              for w in (8, 4))
    r8, r2 = (V.model_bytes(rs, QuantConfig(mode="int", w_bits=w))
              for w in (8, 2))
    assert abs((1 - b4 / b8) - 0.47) < 0.03
    assert 1 - r2 / r8 > 0.6


def _jax_tree(seed):
    """A flat vision tree of the reference: raw leaves and PackedWeights
    of the flattened quantize-eligible weights, as numpy."""
    specs = JV.resnet20_specs(base=8, n_classes=10)
    rng = _rng(seed)
    tree = {}
    for i, (k, s) in enumerate(specs.items()):
        v = rng.randn(*s.shape).astype(np.float32)
        if s.quantize and i % 2:
            pw = jax_prepare(jnp.asarray(v.reshape(-1, s.shape[-1])),
                             JaxQuant(mode="int", w_bits=(8, 4, 2)[i % 3]))
            assert isinstance(pw, JaxPacked)
            tree[k] = {"packed": np.asarray(pw.packed),
                       "scale": np.asarray(pw.scale), "k": pw.k,
                       "n": pw.n, "w_bits": pw.w_bits}
        else:
            tree[k] = v
    return tree


def test_bridge_round_trip_is_bit_exact():
    tree = _jax_tree(5)
    params = vision_from_jax_numpy(tree, device="cpu")
    assert any(isinstance(v, PackedWeight) for v in params.values())
    assert any(isinstance(v, torch.Tensor) for v in params.values())
    back = vision_to_jax_numpy(params)
    assert list(back) == list(tree)
    for k, v in tree.items():
        if isinstance(v, dict):
            assert {f: back[k][f] for f in ("k", "n", "w_bits")} == \
                {f: v[f] for f in ("k", "n", "w_bits")}
            for f in ("packed", "scale"):
                assert back[k][f].dtype == v[f].dtype
                np.testing.assert_array_equal(back[k][f], v[f])
        else:
            assert back[k].dtype == v.dtype
            np.testing.assert_array_equal(back[k], v)


def test_bridged_packed_leaves_give_the_ports_own_forward():
    """The reference's PackedWeight leaves, bridged, give the forward on
    the port's own ``prepare_weight`` leaves of the same raw weights bit
    for bit (a4w2)."""
    specs = V.resnet20_specs(base=8, n_classes=10)
    rng = _rng(6)
    jq = JaxQuant(mode="int", a_bits=4, w_bits=2)
    tq = QuantConfig(mode="int", a_bits=4, w_bits=2)
    raw = {k: (rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1])))
           .astype(np.float32) for k, s in specs.items()}
    tree, own = {}, {}
    for k, v in raw.items():
        if specs[k].quantize:
            pw = jax_prepare(jnp.asarray(v.reshape(-1, v.shape[-1])), jq)
            tree[k] = {"packed": np.asarray(pw.packed),
                       "scale": np.asarray(pw.scale), "k": pw.k, "n": pw.n,
                       "w_bits": pw.w_bits}
            own[k] = prepare_weight(torch.from_numpy(v).reshape(
                -1, v.shape[-1]), tq)
        else:
            tree[k] = v
            own[k] = torch.from_numpy(v)
    x = torch.from_numpy(rng.randn(2, 8, 8, 3).astype(np.float32))
    got = V.resnet20_apply(vision_from_jax_numpy(tree, device="cpu"), x, tq)
    want = V.resnet20_apply(own, x, tq)
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)


def test_init_vision_draws_the_specs_on_the_device_asked():
    specs = V.resnet20_specs(base=8, n_classes=10)
    p = V.init_vision(specs, torch.Generator().manual_seed(0), device="cpu")
    assert list(p) == list(specs)
    for k, s in specs.items():
        assert tuple(p[k].shape) == s.shape and p[k].dtype == torch.float32
    w = p["s2b1c2"]                          # (3, 3, 32, 32)
    assert float(w.std()) == pytest.approx((9 * 32) ** -0.5, rel=0.05)
    again = V.init_vision(specs, torch.Generator().manual_seed(0),
                          device="cpu")
    assert all(torch.equal(p[k], again[k]) for k in p)
