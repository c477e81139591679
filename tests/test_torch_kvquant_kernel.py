"""The port's quantized paged partials against the JAX reference, on the
CPU.

On the CPU the wrappers run their plain versions; ``chip_smoke.py``
holds the CUDA kernels against those on the card.  Here the plain quant
partials meet the Pallas quant bodies ``_gqa_page_kernel_quant`` and
``_mla_page_kernel_quant`` in interpret mode, in float32, on the cases of
``tests/test_quant_pool.py`` (permuted tables with holes, an inactive
slot) plus several query rows, splits of several pages and a page past a
slot's position:

  * what the two frameworks share bit for bit: the quantized pool bytes
    and scales, the dequantized windows the kernels read, and the exact
    identities (-1e30, 0, 0) of every skipped page;
  * the quant partials ARE the fp partials of the dequantized pool, bit
    for bit (the dequantize step is the only new arithmetic);
  * against the Pallas bodies the partials agree within ``atol = rtol =
    1e-5``, as the fp partials do (``test_torch_mla_kernel.py``): not
    bitwise, because ``torch.exp`` and XLA's ``exp`` differ by one ulp on
    ~10% of float32 inputs and XLA's CPU dot sums four FMA lanes
    pairwise where torch sums in another order (ROADMAP queue 3).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.pageformat import get_format as jax_format
from repro.kernels.paged_flash_decode import \
    mla_paged_decode_partials as jax_mla
from repro.kernels.paged_flash_decode import \
    paged_flash_decode_partials as jax_paged
from repro.models.common import paged_gather as jax_gather
from repro_torch.core.pageformat import get_format
from repro_torch.kernels import paged_flash_decode as pfd
from repro_torch.models import attention as tattn
from repro_torch.models.common import paged_gather_quant

TOL = dict(atol=1e-5, rtol=1e-5)
FORMATS = ["int8", "int4"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _gqa_case(seed, sq=1):
    """tests/test_quant_pool.py:110's pools and tables (slot 2 inactive),
    with ``sq`` query rows ending at the same positions."""
    rng = np.random.RandomState(seed)
    n_pages, ps, kv, g, dh = 12, 4, 2, 2, 16
    kf = rng.randn(n_pages, ps, kv, dh).astype(np.float32)
    vf = rng.randn(n_pages, ps, kv, dh).astype(np.float32)
    q = rng.randn(3, sq, kv * g, dh).astype(np.float32)
    tbl = np.array([[5, 2, -1, 7], [1, 6, 3, -1], [-1, -1, -1, -1]],
                   np.int32)
    last = np.array([9, 5, -1])
    qpos = (last[:, None] - sq + 1 + np.arange(sq)[None, :]).astype(np.int32)
    qpos[2] = -1
    kvv = np.array([10, 6, 0], np.int32)
    return kf, vf, q, tbl, qpos, kvv


def _mla_case(seed, b=3):
    """tests/test_quant_pool.py:141's pool and tables, plus an inactive
    slot (position -1); slot 0 maps page 3 wholly past its position."""
    rng = np.random.RandomState(seed)
    n_pages, ps, r, dr, h = 12, 4, 32, 8, 4
    pool = rng.randn(n_pages, ps, r + dr).astype(np.float32)
    qc = rng.randn(b, 1, h, r).astype(np.float32)
    qr = rng.randn(b, 1, h, dr).astype(np.float32)
    tbl = np.array([[5, 2, -1, 7], [1, 6, 3, 0], [4, 8, -1, -1]],
                   np.int32)[:b]
    pb = np.array([9, 13, -1], np.int32)[:b]
    return pool, qc, qr, tbl, pb, r, r + dr


def _quantize(name, *pools):
    """Quantize with the reference: (packed, scales) per pool, numpy."""
    fmt = jax_format(name)
    out = []
    for p in pools:
        q, s = fmt.quantize_rows(jnp.asarray(p))
        out += [np.asarray(q), np.asarray(s)]
    return out


def _gqa_both(name, seed, sq=1, pages_per_split=1):
    kf, vf, q, tbl, qpos, kvv = _gqa_case(seed, sq)
    kq, ks, vq, vs = _quantize(name, kf, vf)
    bits = jax_format(name).bits
    want = jax_paged(jnp.asarray(kq), jnp.asarray(vq), jnp.asarray(q),
                     jnp.asarray(tbl), jnp.asarray(qpos), jnp.asarray(kvv),
                     k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs),
                     bits=bits, interpret=True)
    got = pfd.paged_flash_decode_partials(
        _t(kq), _t(vq), _t(q), _t(tbl), _t(qpos), _t(kvv), k_scale=_t(ks),
        v_scale=_t(vs), bits=bits, pages_per_split=pages_per_split)
    return got, want, (kq, ks, vq, vs, q, tbl, qpos, kvv)


def _mla_both(name, seed, pages_per_split=1):
    pool, qc, qr, tbl, pb, r, sd = _mla_case(seed)
    pq, psc = _quantize(name, pool)
    bits = jax_format(name).bits
    want = jax_mla(jnp.asarray(pq), jnp.asarray(qc), jnp.asarray(qr),
                   jnp.asarray(tbl), jnp.asarray(pb), r, sd,
                   scale_pool=jnp.asarray(psc), bits=bits, interpret=True)
    got = pfd.mla_paged_decode_partials(
        _t(pq), _t(qc), _t(qr), _t(tbl), _t(pb), r, sd, scale_pool=_t(psc),
        bits=bits, pages_per_split=pages_per_split)
    return got, want, (pq, psc, qc, qr, tbl, pb, r, sd)


def _skipped_exact(got, want):
    skip = np.asarray(want[0]) <= -1e30
    assert skip.any() and not skip.all()
    m, l, acc = (x.numpy() for x in got)
    assert (m[skip] == -1e30).all() and (l[skip] == 0).all()
    assert (acc[skip] == 0).all()


@pytest.mark.parametrize("sq", [1, 3])
@pytest.mark.parametrize("name", FORMATS)
def test_gqa_quant_plain_matches_pallas_quant_body(name, sq):
    got, want, _ = _gqa_both(name, 3, sq)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    _skipped_exact(got, want)


@pytest.mark.parametrize("name", FORMATS)
def test_mla_quant_plain_matches_pallas_quant_body(name):
    got, want, _ = _mla_both(name, 5)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    _skipped_exact(got, want)
    assert (got[0][2] == -1e30).all() and (got[2][2] == 0).all()


@pytest.mark.parametrize("name", FORMATS)
def test_dequantized_windows_equal_reference_bitwise(name):
    """The rows both quant bodies read: gathered through the table and
    dequantized to the query type, bit for bit."""
    kq, ks, *_ = _quantize(name, _gqa_case(3)[0])
    pq, psc = _quantize(name, _mla_case(5)[0])
    tbl = np.array([[5, 2, -1, 7], [1, 6, 3, 0]], np.int32)
    jfmt, tfmt = jax_format(name), get_format(name)
    for q, s in ((kq, ks), (pq, psc)):
        want = jfmt.dequantize(jax_gather(jnp.asarray(q), jnp.asarray(tbl)),
                               jax_gather(jnp.asarray(s), jnp.asarray(tbl)),
                               jnp.float32)
        got = paged_gather_quant(_t(q), _t(s), _t(tbl), tfmt, torch.float32)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", FORMATS)
def test_quant_partials_are_fp_partials_of_the_dequantized_pool(name):
    """Dequantizing is the quant bodies' only new arithmetic: the plain
    quant partials equal, bit for bit, the fp partials on the pool
    dequantized row by row."""
    fmt = get_format(name)
    got, _, (kq, ks, vq, vs, q, tbl, qpos, kvv) = _gqa_both(name, 3, 2)
    kd = fmt.dequantize(_t(kq), _t(ks))
    vd = fmt.dequantize(_t(vq), _t(vs))
    fp = pfd.paged_flash_decode_partials(kd, vd, _t(q), _t(tbl), _t(qpos),
                                         _t(kvv))
    for g, f in zip(got, fp):
        assert torch.equal(g, f)
    got, _, (pq, psc, qc, qr, tbl, pb, r, sd) = _mla_both(name, 5)
    fp = pfd.mla_paged_decode_partials(fmt.dequantize(_t(pq), _t(psc)),
                                       _t(qc), _t(qr), _t(tbl), _t(pb), r,
                                       sd)
    for g, f in zip(got, fp):
        assert torch.equal(g, f)


@pytest.mark.parametrize("pages_per_split", [2, 3])
@pytest.mark.parametrize("name", FORMATS)
def test_quant_splits_combine_to_per_page_result(name, pages_per_split):
    per_page, _, _ = _gqa_both(name, 4, 2)
    split, _, _ = _gqa_both(name, 4, 2, pages_per_split)
    assert split[0].shape[-1] == -(-4 // pages_per_split)
    np.testing.assert_allclose(
        tattn._combine_page_partials(*split)[:2].numpy(),
        tattn._combine_page_partials(*per_page)[:2].numpy(), atol=1e-6,
        rtol=1e-6)
    assert (split[0][2] == -1e30).all() and (split[2][2] == 0).all()
    per_page, _, _ = _mla_both(name, 6)
    split, _, _ = _mla_both(name, 6, pages_per_split)
    np.testing.assert_allclose(
        tattn._combine_page_partials(*split)[:2].numpy(),
        tattn._combine_page_partials(*per_page)[:2].numpy(), atol=1e-6,
        rtol=1e-6)
    assert (split[0][2] == -1e30).all() and (split[2][2] == 0).all()


def test_quant_wrappers_validate_inputs():
    kf, vf, q, tbl, qpos, kvv = _gqa_case(7)
    kq, ks, vq, vs = (_t(a) for a in _quantize("int4", kf, vf))
    args = (kq, vq, _t(q), _t(tbl), _t(qpos), _t(kvv))
    with pytest.raises(ValueError, match="bits 2"):
        pfd.paged_flash_decode_partials(*args, k_scale=ks, v_scale=vs,
                                        bits=2)
    with pytest.raises(ValueError, match="head_dim"):    # int4 read as int8
        pfd.paged_flash_decode_partials(*args, k_scale=ks, v_scale=vs,
                                        bits=8)
    with pytest.raises(ValueError, match="row scales"):
        pfd.paged_flash_decode_partials(*args, k_scale=ks[:, :2],
                                        v_scale=vs, bits=4)
    with pytest.raises(ValueError, match="row scales"):
        pfd.paged_flash_decode_partials(*args, k_scale=None, v_scale=vs,
                                        bits=4)
    with pytest.raises(TypeError, match="int8 rows"):
        pfd.paged_flash_decode_partials(kq.float(), vq.float(),
                                        *args[2:], k_scale=ks, v_scale=vs,
                                        bits=4)
    with pytest.raises(ValueError, match="without bits"):
        pfd.paged_flash_decode_partials(*args, k_scale=ks, v_scale=vs)
    pool, qc, qr, tbl, pb, r, sd = _mla_case(8)
    pq, psc = (_t(a) for a in _quantize("int8", pool))
    margs = (pq, _t(qc), _t(qr), _t(tbl), _t(pb), r, sd)
    with pytest.raises(ValueError, match="row width"):    # int8 read as int4
        pfd.mla_paged_decode_partials(*margs, scale_pool=psc, bits=4)
    with pytest.raises(ValueError, match="row scales"):
        pfd.mla_paged_decode_partials(*margs, scale_pool=psc.double(),
                                      bits=8)
