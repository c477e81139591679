"""The port's packed matmuls against the JAX reference, on the CPU.

On the CPU the wrappers of :mod:`repro_torch.kernels.mpq_matmul` run their
plain PyTorch versions (the CUDA kernels are held against those on the
card by ``chip_smoke.py``).  Here the plain versions meet the reference's
oracles ``repro.kernels.ref`` on the same numpy inputs: the integer path
BITWISE for every Table IV format, the weight-only path within
``rtol = atol = 1e-5`` in float32.  K = 4096 is included: the port must
compute the oracle's function whatever the number of K tiles.

The Pallas kernels themselves (interpret mode) are compared only where
they hold their own oracle: one K tile, or equal pack factors.  With
several K tiles and unequal factors they do not (ROADMAP queue 3, the
reference fault of the strided layout), so the K = 4096 cases compare
with the oracle alone.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core.packing import pack as jax_pack
from repro.core.quant import QuantConfig as JaxQuant
from repro.core.quant import quantize_activation as jax_quantize_activation
from repro.core.quant import quantize_weight as jax_quantize_weight
from repro.kernels import ref
from repro.kernels.mpq_matmul import mpq_matmul_kernel, wo_matmul_kernel
from repro.kernels.ops import prepare_weight as jax_prepare
from repro.kernels.ops import quantized_matmul as jax_qmm
from repro_torch.core.quant import QuantConfig, qmax, qmin
from repro_torch.kernels import mpq_matmul as mm
from repro_torch.kernels.ops import prepare_weight, quantized_matmul

FORMATS_INT = [(8, 8), (8, 4), (8, 2), (4, 4), (4, 2), (2, 2)]
SHAPES = [(16, 256, 128), (100, 512, 384), (1, 256, 256), (33, 1024, 100),
          (8, 4096, 256)]
# bf16 x: the plain version and the oracle both sum exact float32
# products, in different orders; the result is rounded once to bf16, so
# the two may land one bf16 step (2^-8 relative) apart.
BF16_RTOL = 2 ** -7


def _t(a) -> torch.Tensor:
    a = np.array(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _int_operands(m, k, n, a_bits, w_bits, seed):
    """Packed operands and scales, made with numpy and packed by JAX."""
    rng = np.random.RandomState(seed)
    xq = rng.randint(qmin(a_bits), qmax(a_bits) + 1, (m, k)).astype(np.int8)
    wq = rng.randint(qmin(w_bits), qmax(w_bits) + 1, (k, n)).astype(np.int8)
    xq[0, :] = qmin(a_bits)                       # extreme products
    wq[:, 0] = qmin(w_bits)
    xp = np.asarray(jax_pack(jnp.asarray(xq), a_bits, axis=1))
    wp = np.asarray(jax_pack(jnp.asarray(wq), w_bits, axis=0))
    xs = (rng.rand(m, 1) * 1e-2 + 1e-4).astype(np.float32)
    ws = (rng.rand(n) * 1e-2 + 1e-4).astype(np.float32)
    return xp, xs, wp, ws


@pytest.mark.parametrize("a_bits,w_bits", FORMATS_INT)
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_int_plain_bitwise_equals_oracle(a_bits, w_bits, m, k, n):
    xp, xs, wp, ws = _int_operands(m, k, n, a_bits, w_bits, seed=m + k + n)
    want = np.asarray(ref.mpq_matmul_ref(
        jnp.asarray(xp), jnp.asarray(xs), jnp.asarray(wp), jnp.asarray(ws),
        a_bits=a_bits, w_bits=w_bits))
    got = mm.mpq_matmul(_t(xp), _t(xs), _t(wp), _t(ws)[None, :],
                        a_bits=a_bits, w_bits=w_bits)
    assert got.dtype == torch.float32
    assert want.tobytes() == got.numpy().tobytes()


def _wo_operands(m, k, n, w_bits, dtype, seed):
    """Unit-normal activations and a N(0, 0.05^2) weight quantized per
    channel by the reference (so the scales are those of real use)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(m, k).astype(np.float32)
    x = x.astype(ml_dtypes.bfloat16) if dtype == "bf16" else x
    w = jnp.asarray((rng.randn(k, n) * 0.05).astype(np.float32))
    wq, ws = jax_quantize_weight(w, w_bits)
    wp = np.asarray(jax_pack(wq, w_bits, axis=0))
    return x, wp, np.asarray(ws)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("w_bits", [8, 4, 2])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_wo_plain_matches_oracle(dtype, w_bits, m, k, n):
    x, wp, ws = _wo_operands(m, k, n, w_bits, dtype, seed=w_bits + m)
    want = np.asarray(ref.wo_matmul_ref(
        jnp.asarray(x), jnp.asarray(wp), jnp.asarray(ws),
        w_bits=w_bits)).astype(np.float32)
    got = mm.wo_matmul(_t(x), _t(wp), _t(ws)[None, :], w_bits=w_bits)
    assert got.dtype == (torch.float32 if dtype == "f32" else torch.bfloat16)
    got = got.float().numpy()
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=BF16_RTOL, atol=1e-5)


# -- the Pallas kernels in interpret mode, where they hold their oracle ------

@pytest.mark.parametrize("a_bits,w_bits", FORMATS_INT)
def test_int_plain_equals_pallas_one_k_tile(a_bits, w_bits):
    m, k, n = 16, 512, 128
    xp, xs, wp, ws = _int_operands(m, k, n, a_bits, w_bits, seed=7)
    want = np.asarray(mpq_matmul_kernel(
        jnp.asarray(xp), jnp.asarray(xs), jnp.asarray(wp),
        jnp.asarray(ws)[None, :], a_bits=a_bits, w_bits=w_bits, bm=16, bk=k,
        bn=128, interpret=True))
    got = mm.mpq_matmul(_t(xp), _t(xs), _t(wp), _t(ws)[None, :],
                        a_bits=a_bits, w_bits=w_bits)
    assert want.tobytes() == got.numpy().tobytes()


@pytest.mark.parametrize("a_bits,w_bits", [(8, 8), (4, 4), (2, 2)])
def test_int_plain_equals_pallas_equal_factors_many_k_tiles(a_bits, w_bits):
    m, k, n = 16, 1024, 128
    xp, xs, wp, ws = _int_operands(m, k, n, a_bits, w_bits, seed=8)
    want = np.asarray(mpq_matmul_kernel(
        jnp.asarray(xp), jnp.asarray(xs), jnp.asarray(wp),
        jnp.asarray(ws)[None, :], a_bits=a_bits, w_bits=w_bits, bm=16,
        bk=256, bn=128, interpret=True))
    got = mm.mpq_matmul(_t(xp), _t(xs), _t(wp), _t(ws)[None, :],
                        a_bits=a_bits, w_bits=w_bits)
    assert want.tobytes() == got.numpy().tobytes()


@pytest.mark.parametrize("w_bits", [8, 4, 2])
def test_wo_plain_matches_pallas_one_k_tile(w_bits):
    m, k, n = 16, 512, 128
    x, wp, ws = _wo_operands(m, k, n, w_bits, "f32", seed=9)
    want = np.asarray(wo_matmul_kernel(
        jnp.asarray(x), jnp.asarray(wp), jnp.asarray(ws)[None, :],
        w_bits=w_bits, bm=16, bk=k, bn=128, interpret=True))
    got = mm.wo_matmul(_t(x), _t(wp), _t(ws)[None, :], w_bits=w_bits)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# -- quantized_matmul: padding, activation quantization, unpadding -----------

@pytest.mark.parametrize("mode,a_bits,w_bits", [
    ("wo", 8, 8), ("wo", 8, 4), ("wo", 8, 2), ("int", 8, 8), ("int", 8, 4),
    ("int", 4, 4), ("int", 4, 2), ("int", 2, 2)])
def test_quantized_matmul_matches_reference(mode, a_bits, w_bits):
    """The reference's jitted ``quantized_matmul`` (oracle path) and the
    port's, on (2, 7, 300) x (300, 130): K padded to 512, N to 256 and
    back.  On the integer path XLA's jit computes the activation scale as
    ``amax * (1/qmax)``, one float32 ulp from the ``amax / qmax`` that
    the reference's code (run eagerly) and the port compute; so the jitted
    result agrees within a few ulps (rtol 1e-6), and the same steps run
    eagerly agree bitwise."""
    rng = np.random.RandomState(a_bits * 10 + w_bits)
    x = rng.randn(2, 7, 300).astype(np.float32)
    w = rng.randn(300, 130).astype(np.float32)
    jcfg = JaxQuant(mode=mode, a_bits=a_bits, w_bits=w_bits)
    tcfg = QuantConfig(mode=mode, a_bits=a_bits, w_bits=w_bits)
    jpw = jax_prepare(jnp.asarray(w), jcfg)
    want = np.asarray(jax_qmm(jnp.asarray(x), jpw, jcfg, use_kernel=False))
    got = quantized_matmul(_t(x), prepare_weight(_t(w), tcfg), tcfg)
    assert tuple(got.shape) == (2, 7, 130) and got.dtype == torch.float32
    if mode == "wo":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
        return
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    x2 = jnp.pad(jnp.asarray(x).reshape(14, 300), ((0, 0), (0, 212)))
    xq, xs = jax_quantize_activation(x2, a_bits)
    eager = np.asarray(ref.mpq_matmul_ref(
        jax_pack(xq, a_bits, axis=1), xs, jpw.packed, jpw.scale,
        a_bits=a_bits, w_bits=w_bits))[:, :130].reshape(2, 7, 130)
    assert eager.tobytes() == got.numpy().tobytes()


def test_wrappers_check_their_operands():
    wp = torch.zeros(64, 8, dtype=torch.int8)
    ws = torch.ones(1, 8)
    with pytest.raises(ValueError, match="holds K"):
        mm.wo_matmul(torch.zeros(2, 100), wp, ws, w_bits=4)
    with pytest.raises(ValueError, match="w_scale"):
        mm.wo_matmul(torch.zeros(2, 128), wp, torch.ones(8), w_bits=4)
    with pytest.raises(ValueError, match="x_scale"):
        mm.mpq_matmul(torch.zeros(2, 64, dtype=torch.int8), torch.ones(2),
                      wp, ws, a_bits=4, w_bits=4)
    with pytest.raises(TypeError, match="int8"):
        mm.mpq_matmul(torch.zeros(2, 64), torch.ones(2, 1), wp, ws,
                      a_bits=4, w_bits=4)
