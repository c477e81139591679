"""The port's MLA kernel modules against the JAX reference, on the CPU.

On the CPU each wrapper runs its plain PyTorch version (the CUDA kernels
are held against those on the card by ``chip_smoke.py``).  Here they meet
the JAX package on the same numpy inputs, in float32:

  * the compressed-space MLA partials (``mla_paged_decode_partials``)
    against the Pallas body in interpret mode and against the lax
    ``mla._mla_window_partials`` it mirrors: permuted tables with holes,
    a partly filled last page, a page wholly past the slot's position and
    an inactive slot (position -1).  Skipped pages give the exact
    identities bit for bit; the rest agree within ``atol = rtol = 1e-5``;
  * splits of several pages combine to the per-page result;
  * the flash forward and the paged partials at MLA's unequal widths
    (q/k 24, v 16: the ``mla`` family config's nope 16 + rope 8) against
    the reference's ``sdpa`` and ``attention._page_partials``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_flash_decode import \
    mla_paged_decode_partials as jax_mla
from repro.kernels.paged_flash_decode import \
    paged_flash_decode_partials as jax_paged
from repro.models.attention import _combine_page_partials, _page_partials, sdpa
from repro.models.common import paged_gather as jax_gather
from repro.models.mla import _mla_window_partials
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_flash_decode as pfd
from repro_torch.models import attention as tattn
from repro_torch.models.common import paged_gather

TOL = dict(atol=1e-5, rtol=1e-5)
R, DR, H, PS, P, N = 32, 8, 4, 4, 5, 16
SCALE_DIM = 16 + DR                     # qk_nope + qk_rope of the mla config


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _mla_case(seed, b=4, sq=1):
    """Latent pool, absorbed queries and per-slot tables: slot 0 has a
    hole and a partly filled last page, slot 1 maps a page wholly past
    its position, slot 2 is full to its last row, and slot 3 is inactive
    (empty table, position -1)."""
    rng = np.random.RandomState(seed)
    pool = rng.randn(N, PS, R + DR).astype(np.float32)
    qc = rng.randn(b, sq, H, R).astype(np.float32)
    qr = rng.randn(b, sq, H, DR).astype(np.float32)
    perm = rng.permutation(N)
    tbl = np.full((b, P), -1, np.int32)
    tbl[0, :4] = perm[:4]
    tbl[0, 1] = -1                                   # hole mid-table
    tbl[1, :3] = perm[4:7]                           # page 2 past pos 6
    tbl[2, :] = perm[7:12]
    pos = np.array([13, 6, P * PS - 1, -1], np.int32)[:b]
    return pool, qc, qr, tbl, pos


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mla_plain_matches_pallas_interpret(seed):
    case = _mla_case(seed)
    want = jax_mla(*[jnp.asarray(a) for a in case], R, SCALE_DIM,
                   interpret=True)
    got = pfd.mla_paged_decode_partials(*[_t(a) for a in case], R,
                                        SCALE_DIM)
    for gt, wt in zip(got, want):
        assert gt.dtype == torch.float32
        np.testing.assert_allclose(gt.numpy(), np.asarray(wt), **TOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mla_plain_matches_window_partials(seed):
    pool, qc, qr, tbl, pos = _mla_case(seed)
    jt = jnp.asarray(tbl)
    want = _mla_window_partials(jax_gather(jnp.asarray(pool), jt),
                                jnp.asarray(qc), jnp.asarray(qr), jt,
                                jnp.asarray(pos), R, SCALE_DIM)
    got = pfd.mla_paged_decode_partials(_t(pool), _t(qc), _t(qr), _t(tbl),
                                        _t(pos), R, SCALE_DIM)
    for gt, wt in zip(got, want):
        np.testing.assert_allclose(gt.numpy(), np.asarray(wt), **TOL)
    np.testing.assert_allclose(
        tattn._combine_page_partials(*got)[:3].numpy(),
        np.asarray(_combine_page_partials(*want))[:3], **TOL)


def test_mla_skipped_pages_are_exact_identities():
    pool, qc, qr, tbl, pos = _mla_case(3)
    m, l, acc = pfd.mla_paged_decode_partials(
        _t(pool), _t(qc), _t(qr), _t(tbl), _t(pos), R, SCALE_DIM)
    skip = (tbl < 0) | (np.arange(P)[None, :] * PS > pos[:, None])
    assert skip[0, 1] and skip[1, 3] and skip[3].all() and not skip[2].any()
    for i, j in zip(*np.nonzero(skip)):
        assert (m[i, ..., j] == -1e30).all()
        assert (l[i, ..., j] == 0).all()
        assert (acc[i, ..., j, :] == 0).all()
    # live pages: a finite max and a positive denominator
    live = ~skip
    assert (m.numpy()[:, 0].transpose(0, 2, 1)[live] > -1e29).all()
    assert (l.numpy()[:, 0].transpose(0, 2, 1)[live] > 0).all()


@pytest.mark.parametrize("pages_per_split", [2, 3])
def test_mla_splits_combine_to_per_page_result(pages_per_split):
    case = [_t(a) for a in _mla_case(4)]
    per_page = pfd.mla_paged_decode_partials(*case, R, SCALE_DIM)
    split = pfd.mla_paged_decode_partials(*case, R, SCALE_DIM,
                                          pages_per_split=pages_per_split)
    assert split[0].shape[-1] == -(-P // pages_per_split)
    assert split[2].shape[-2:] == (-(-P // pages_per_split), R)
    np.testing.assert_allclose(
        tattn._combine_page_partials(*split)[:3].numpy(),
        tattn._combine_page_partials(*per_page)[:3].numpy(),
        atol=1e-6, rtol=1e-6)
    # the inactive slot stays all identities in every split
    assert (split[0][3] == -1e30).all() and (split[2][3] == 0).all()


def test_mla_plain_takes_several_query_rows():
    """The Pallas body takes Sq > 1 (every row at the slot's position)."""
    case = _mla_case(5, b=3, sq=2)
    want = jax_mla(*[jnp.asarray(a) for a in case], R, SCALE_DIM,
                   interpret=True)
    got = pfd.mla_paged_decode_partials(*[_t(a) for a in case], R,
                                        SCALE_DIM)
    for gt, wt in zip(got, want):
        np.testing.assert_allclose(gt.numpy(), np.asarray(wt), **TOL)


def test_mla_bf16_rounds_weights_before_the_product():
    """In bf16 the weights are rounded to the input type before the
    weighted sum, as the reference casts them: the plain version's acc
    equals a float64 sum of the rounded weights times the pool."""
    pool, qc, qr, tbl, pos = (_t(a) for a in _mla_case(6))
    pool, qc, qr = (x.to(torch.bfloat16) for x in (pool, qc, qr))
    m, l, acc = pfd.mla_paged_decode_partials(pool, qc, qr, tbl, pos, R,
                                              SCALE_DIM)
    buf = paged_gather(pool, tbl).double()
    sc = (torch.einsum("bqhr,bsr->bqhs", qc.double(), buf[..., :R])
          + torch.einsum("bqhd,bsd->bqhs", qr.double(), buf[..., R:])) \
        * SCALE_DIM ** -0.5
    j = 0                                       # slot 0, page 0: rows 0-3
    w = torch.exp(sc[0, 0, :, :PS] - m[0, 0, :, j, None].double())
    got = acc[0, 0, :, j].double()
    rounded = w.to(torch.bfloat16).double() @ buf[0, :PS, :R]
    # float32 summation of exact bf16 x bf16 products: within 1e-6; the
    # unrounded weights land 2e-3 to 5e-3 away on these inputs
    assert (got - rounded).abs().max() <= 1e-6
    assert (got - w @ buf[0, :PS, :R]).abs().max() > 1e-4


def test_mla_wrapper_validates_inputs():
    pool, qc, qr, tbl, pos = (_t(a) for a in _mla_case(7))
    with pytest.raises(TypeError):
        pfd.mla_paged_decode_partials(pool, qc, qr, tbl.long(), pos, R,
                                      SCALE_DIM)
    with pytest.raises(TypeError):
        pfd.mla_paged_decode_partials(pool.double(), qc, qr, tbl, pos, R,
                                      SCALE_DIM)
    with pytest.raises(ValueError):                  # r disagrees
        pfd.mla_paged_decode_partials(pool, qc, qr, tbl, pos, R - 8,
                                      SCALE_DIM)
    with pytest.raises(ValueError):                  # pos not (B,)
        pfd.mla_paged_decode_partials(pool, qc, qr, tbl, pos[:2], R,
                                      SCALE_DIM)
    with pytest.raises(ValueError):
        pfd.mla_paged_decode_partials(pool, qc, qr, tbl, pos, R, SCALE_DIM,
                                      pages_per_split=0)


# -- the GQA kernels at MLA's unequal widths (q/k 24, v 16) -------------------

def _naive_inputs(seed, b, s, h, dk, dv):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, s, h, dk).astype(np.float32),
            rng.randn(b, s, h, dk).astype(np.float32),
            rng.randn(b, s, h, dv).astype(np.float32))


@pytest.mark.parametrize("s", [16, 11])
def test_flash_plain_unequal_widths_matches_sdpa(s):
    q, k, v = _naive_inputs(8, 2, s, H, 24, 16)
    want = sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                kv_valid=jnp.int32(s))
    got = fa.flash_attention(_t(q), _t(k), _t(v), kv_valid=s)
    assert tuple(got.shape) == (2, s, H, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_flash_wrapper_rejects_mismatched_value_rows():
    q, k, v = (_t(a) for a in _naive_inputs(9, 1, 8, H, 24, 16))
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, v[:, :4])
    with pytest.raises(ValueError):
        fa.flash_attention(q, k[..., :16], v)


def _expanded_case(seed, b=3, sq=5):
    """An MLA resumed chunk's view: a window expanded to (B*P, ps, H, dk)
    and (B*P, ps, H, dv) pools, page b*P + j = slot b's logical page j,
    unmapped pages -1, absolute query positions."""
    rng = np.random.RandomState(seed)
    kp = rng.randn(b * P, PS, H, 24).astype(np.float32)
    vp = rng.randn(b * P, PS, H, 16).astype(np.float32)
    q = rng.randn(b, sq, H, 24).astype(np.float32)
    own = np.arange(b * P, dtype=np.int32).reshape(b, P)
    mapped = np.array([4, 3, 5])[:b]
    tbl = np.where(np.arange(P)[None, :] < mapped[:, None], own, -1)
    tbl = tbl.astype(np.int32)
    kvv = np.array([15, 9, 20], np.int32)[:b]
    qpos = (kvv[:, None] - sq + np.arange(sq)[None, :]).astype(np.int32)
    return kp, vp, q, tbl, qpos, kvv


def test_paged_plain_unequal_widths_matches_page_partials():
    kp, vp, q, tbl, qpos, kvv = _expanded_case(10)
    jt = jnp.asarray(tbl)
    want = _page_partials(jnp.asarray(q), jax_gather(jnp.asarray(kp), jt),
                          jax_gather(jnp.asarray(vp), jt), jt,
                          jnp.asarray(qpos), jnp.asarray(kvv))
    got = pfd.paged_flash_decode_partials(_t(kp), _t(vp), _t(q), _t(tbl),
                                          _t(qpos), _t(kvv))
    assert got[2].shape[-1] == 16
    for gt, wt in zip(got, want):
        np.testing.assert_allclose(gt.numpy(), np.asarray(wt), **TOL)


def test_paged_plain_unequal_widths_matches_pallas_interpret():
    case = _expanded_case(11)
    want = jax_paged(*[jnp.asarray(a) for a in case], interpret=True)
    got = pfd.paged_flash_decode_partials(*[_t(a) for a in case])
    for gt, wt in zip(got, want):
        np.testing.assert_allclose(gt.numpy(), np.asarray(wt), **TOL)


def test_paged_unequal_widths_splits_combine_to_per_page_result():
    case = [_t(a) for a in _expanded_case(12)]
    per_page = pfd.paged_flash_decode_partials(*case)
    split = pfd.paged_flash_decode_partials(*case, pages_per_split=2)
    np.testing.assert_allclose(
        tattn._combine_page_partials(*split).numpy(),
        tattn._combine_page_partials(*per_page).numpy(), atol=1e-6,
        rtol=1e-6)


def test_pages_per_split_sizes_mla_partials_by_the_latent_width():
    # decode at deepseek-v2-lite's widths stays per page (8 slots, 16
    # heads, r 512, 128 pages); a resumed 256-row chunk over the expanded
    # window (v 128) walks several pages per block
    assert tattn._pages_per_split(8, 1, 16, 128, 512) == 1
    c = tattn._pages_per_split(8, 256, 16, 128, 128)
    assert c > 1 and 8 * 256 * 16 * -(-128 // c) * 128 * 4 <= \
        tattn.PARTIALS_BYTES_BUDGET
