"""The quantized GQA paged partials at a chunk's shapes, in bf16, on the
CPU.

On the card a bf16 call with more than 16 query rows (Sq x G) on an int8
or int4 pool takes the kernel's tensor-core chunk route, which
``chip_smoke.py`` holds against the plain version below and, bit for
bit, against the fp chunk route on the same pool dequantized.  Here the
plain versions meet the reference on such a call: Sq 12 query rows of G
2 heads (24 rows a KV head), on a pool with a hole mid-table, a mapped
page past a slot's position and an inactive slot, in splits of 1, 2
and 3 pages.

  * Against the Pallas body ``_gqa_page_kernel_quant`` in interpret mode:
    the scores' max ``m`` and the sums ``l`` within ``atol = rtol =
    1e-5`` (both sum exact products of bf16 values in float32, in
    another order, and ``torch.exp`` and XLA's ``exp`` differ by an ulp);
    ``acc`` and the combined output within ``BF16_TOL`` (below).  Skipped
    pages and splits are the exact identities (-1e30, 0, 0).
  * The bf16 quant partials ARE the fp partials of the pool dequantized
    to bf16 by ``PageFormat.dequantize``, bit for bit, at every split.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core.pageformat import get_format as jax_format
from repro.kernels.paged_flash_decode import \
    paged_flash_decode_partials as jax_paged
from repro_torch.core.pageformat import get_format
from repro_torch.kernels import paged_flash_decode as pfd
from repro_torch.models import attention as tattn

FORMATS = ["int8", "int4"]
SPLITS = [1, 2, 3]
TOL = dict(atol=1e-5, rtol=1e-5)
# acc and the combined output: both versions round each softmax weight
# to bf16 before the PV product, from float32 exponents of scores summed
# in another order, and at 2-3 pages a split against the split's running
# max instead of the page's, so a weight may land one bf16 step (2^-8 of
# itself) apart; the pool rows are of magnitude ~1 and the weights of a
# row sum to its l, so two such steps bound the combined output's
# difference (measured: at most 2.2e-3, at 2-3 pages a split)
BF16_TOL = dict(atol=2 ** -7, rtol=2 ** -7)

SQ, KV, G, DH, PS, P = 12, 2, 2, 16, 4, 6


def _t(a) -> torch.Tensor:
    a = np.array(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _case(seed):
    """Three slots of SQ query rows: slot 0 with a hole mid-table, slot 1
    with a mapped page wholly past its last position, slot 2 inactive
    (positions -1, nothing filled, its pages still mapped)."""
    rng = np.random.RandomState(seed)
    n_pages = 20
    kf = rng.randn(n_pages, PS, KV, DH).astype(np.float32)
    vf = rng.randn(n_pages, PS, KV, DH).astype(np.float32)
    q = rng.randn(3, SQ, KV * G, DH).astype(ml_dtypes.bfloat16)
    perm = rng.permutation(n_pages)
    tbl = np.stack([perm[:P], perm[P:2 * P], perm[2 * P:3 * P]]) \
        .astype(np.int32)
    tbl[0, 1] = -1                                   # a hole
    tbl[1, 5] = -1
    fill = np.array([20, 13, 0])
    qpos = (fill[:, None] - SQ + np.arange(SQ)[None, :]).astype(np.int32)
    qpos[2] = -1                                     # the inactive slot
    assert SQ * G > 16 and 4 * PS > qpos[1].max()    # page 4 of slot 1
    return kf, vf, q, tbl, qpos, fill.astype(np.int32)


def _both(name, seed, c):
    """The port's bf16 quant partials at ``c`` pages a split, the Pallas
    body's per-page partials, and the quantized pools and inputs."""
    kf, vf, q, tbl, qpos, kvv = _case(seed)
    fmt = jax_format(name)
    kq, ks = (np.asarray(x) for x in fmt.quantize_rows(jnp.asarray(kf)))
    vq, vs = (np.asarray(x) for x in fmt.quantize_rows(jnp.asarray(vf)))
    want = jax_paged(jnp.asarray(kq), jnp.asarray(vq), jnp.asarray(q),
                     jnp.asarray(tbl), jnp.asarray(qpos), jnp.asarray(kvv),
                     k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs),
                     bits=fmt.bits, interpret=True)
    ins = [_t(a) for a in (kq, vq, q, tbl, qpos, kvv, ks, vs)]
    got = pfd.paged_flash_decode_partials(
        *ins[:6], k_scale=ins[6], v_scale=ins[7], bits=fmt.bits,
        pages_per_split=c)
    return got, [np.asarray(w, np.float32) for w in want], ins


@pytest.mark.parametrize("c", SPLITS)
@pytest.mark.parametrize("name", FORMATS)
def test_bf16_chunk_plain_matches_pallas_quant_body(name, c):
    got, want, _ = _both(name, 11, c)
    assert all(g.dtype == torch.float32 for g in got)
    assert got[0].shape[-1] == -(-P // c)
    if c == 1:
        np.testing.assert_allclose(got[0].numpy(), want[0], **TOL)
        np.testing.assert_allclose(got[1].numpy(), want[1], **TOL)
        np.testing.assert_allclose(got[2].numpy(), want[2], **BF16_TOL)
    out = tattn._combine_page_partials(*got).numpy()
    ref = tattn._combine_page_partials(*(_t(w) for w in want)).numpy()
    np.testing.assert_allclose(out, ref, **BF16_TOL)
    # the inactive slot, every split past a slot's last page, and the
    # per-page hole are the exact identities
    for s in range(got[0].shape[-1]):
        pages = range(s * c, min((s + 1) * c, P))
        skip = np.all(want[0][..., list(pages)] <= -1e30, axis=-1)
        assert skip[2].all()
        m, l, acc = (x.numpy()[..., s] if x.dim() == 5 else
                     x.numpy()[..., s, :] for x in got)
        assert (m[skip] == -1e30).all() and (l[skip] == 0).all()
        assert (acc[skip] == 0).all()
    assert (got[0][2] == -1e30).all() and (got[2][2] == 0).all()


@pytest.mark.parametrize("c", SPLITS)
@pytest.mark.parametrize("name", FORMATS)
def test_bf16_chunk_quant_partials_are_fp_partials_of_dequantized_pool(
        name, c):
    """Dequantizing to bf16 is the quant route's only new arithmetic: the
    plain quant partials equal, bit for bit, the plain fp partials of the
    pool dequantized row by row to bf16 (what chip_smoke holds the card's
    quant chunk route to against its fp chunk route)."""
    got, _, (kq, vq, q, tbl, qpos, kvv, ks, vs) = _both(name, 12, c)
    fmt = get_format(name)
    kd = fmt.dequantize(kq, ks, torch.bfloat16)
    vd = fmt.dequantize(vq, vs, torch.bfloat16)
    assert kd.dtype == torch.bfloat16 and kd.shape[-1] == DH
    fp = pfd.paged_flash_decode_partials(kd, vd, q, tbl, qpos, kvv,
                                         pages_per_split=c)
    for g, f in zip(got, fp):
        assert torch.equal(g, f)
