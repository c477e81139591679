"""The port's quantization and packing against the JAX reference, on the CPU.

``repro_torch.core.quant``, ``repro_torch.core.packing`` and
``repro_torch.kernels.ops.prepare_weight`` must give the reference's
integers, scales and packed bytes BITWISE on the same numpy inputs: both
divide in float32 and round half to even.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import packing as jpacking
from repro.core import quant as jquant
from repro.kernels.ops import prepare_weight as jax_prepare
from repro_torch.core import packing, quant
from repro_torch.core.quant import QuantConfig
from repro_torch.kernels.ops import PackedWeight, prepare_weight


def _t(a: np.ndarray) -> torch.Tensor:
    a = np.array(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _same(want, got: torch.Tensor):
    want = np.asarray(want)
    if got.dtype == torch.bfloat16:
        got = got.view(torch.int16)
        want = want.view(np.int16)
    got = got.numpy()
    assert want.dtype == got.dtype and want.shape == got.shape, \
        (want.dtype, got.dtype, want.shape, got.shape)
    assert want.tobytes() == got.tobytes()


def _inputs(shape, dtype, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * rng.choice([0.01, 1.0, 30.0])).astype(np.float32)
    x.flat[0] = 0.0                    # a zero and a tie-prone value
    x.flat[-1] = 2.5 * np.abs(x).max() / 127
    return x.astype(ml_dtypes.bfloat16) if dtype == "bf16" else x


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("axis", [None, 0, -1])
def test_quantize_bitwise(dtype, bits, axis):
    x = _inputs((37, 19), dtype, seed=bits)
    jq, js = jquant.quantize(jnp.asarray(x), bits, axis=axis)
    tq, ts = quant.quantize(_t(x), bits, axis=axis)
    _same(jq, tq)
    _same(js, ts)
    _same(jquant.dequantize(jq, js), quant.dequantize(tq, ts))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("granularity", ["channel", "tensor"])
def test_quantize_weight_bitwise(dtype, bits, granularity):
    w = _inputs((64, 24), dtype, seed=10 + bits)
    jq, js = jquant.quantize_weight(jnp.asarray(w), bits, granularity)
    tq, ts = quant.quantize_weight(_t(w), bits, granularity)
    _same(jq, tq)
    _same(js, ts)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("bits", [8, 4, 2])
def test_quantize_activation_bitwise(dtype, bits):
    x = _inputs((3, 5, 40), dtype, seed=20 + bits)
    jq, js = jquant.quantize_activation(jnp.asarray(x), bits)
    tq, ts = quant.quantize_activation(_t(x), bits)
    _same(jq, tq)
    _same(js, ts)


@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("kp", [3, 4])            # odd and even packed length
@pytest.mark.parametrize("axis", [0, 1])
def test_pack_unpack_bitwise(bits, kp, axis):
    f = packing.pack_factor(bits)
    rng = np.random.RandomState(bits * 10 + kp)
    shape = [kp * f, 5] if axis == 0 else [5, kp * f]
    q = rng.randint(quant.qmin(bits), quant.qmax(bits) + 1,
                    shape).astype(np.int8)
    q.flat[0], q.flat[-1] = quant.qmin(bits), quant.qmax(bits)   # extremes
    jp = jpacking.pack(jnp.asarray(q), bits, axis=axis)
    tp = packing.pack(torch.from_numpy(q), bits, axis=axis)
    _same(jp, tp)
    assert tuple(tp.shape) == packing.packed_shape(q.shape, bits, axis)
    _same(jpacking.unpack(jp, bits, axis=axis),
          packing.unpack(tp, bits, axis=axis))
    _same(q, packing.unpack(tp, bits, axis=axis))


def test_pack_rejects_ragged_axis():
    with pytest.raises(ValueError, match="not divisible"):
        packing.pack(torch.zeros(5, 2, dtype=torch.int8), 4)
    with pytest.raises(ValueError, match="bits must be"):
        packing.pack_factor(3)


def test_random_qtensor_spans_the_range():
    g = torch.Generator().manual_seed(0)
    q = packing.random_qtensor(g, (4096,), 2)
    assert q.dtype == torch.int8
    assert sorted(torch.unique(q).tolist()) == [-2, -1, 0, 1]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("k,n,granularity", [(300, 130, "channel"),
                                             (256, 128, "channel"),
                                             (300, 130, "tensor")])
def test_prepare_weight_bitwise(dtype, bits, k, n, granularity):
    w = _inputs((k, n), dtype, seed=k + n + bits)
    jcfg = jquant.QuantConfig(mode="wo", w_bits=bits,
                              w_granularity=granularity)
    tcfg = QuantConfig(mode="wo", w_bits=bits, w_granularity=granularity)
    jpw = jax_prepare(jnp.asarray(w), jcfg)
    tpw = prepare_weight(_t(w), tcfg)
    assert isinstance(tpw, PackedWeight)
    assert (tpw.k, tpw.n, tpw.w_bits) == (jpw.k, jpw.n, jpw.w_bits)
    _same(jpw.packed, tpw.packed)
    _same(jpw.scale, tpw.scale)
    assert tpw.nbytes == jpw.nbytes
    assert tpw.packed.shape[0] * packing.pack_factor(bits) % 256 == 0
    assert tpw.packed.shape[1] % 128 == 0


@pytest.mark.parametrize("kw,field", [
    (dict(mode="fp8"), "mode"), (dict(mode="int", a_bits=3), "a_bits"),
    (dict(mode="wo", w_bits=16), "w_bits"),
    (dict(mode="int", w_granularity="row"), "w_granularity")])
def test_quant_config_errors_name_the_field(kw, field):
    with pytest.raises(ValueError, match=rf"QuantConfig\.{field}"):
        QuantConfig(**kw)


def test_qat_mode_raises_with_its_roadmap_item():
    with pytest.raises(ValueError, match="ROADMAP queue 1 item 16"):
        QuantConfig(mode="qat")


@pytest.mark.parametrize("kw,tag", [
    (dict(), "bf16"), (dict(mode="wo", w_bits=4), "w4a16"),
    (dict(mode="int", a_bits=8, w_bits=8), "w8a8"),
    (dict(mode="int", a_bits=8, w_bits=4), "w4a8")])
def test_quant_config_tag_matches_reference(kw, tag):
    assert QuantConfig(**kw).tag() == jquant.QuantConfig(**kw).tag() == tag
