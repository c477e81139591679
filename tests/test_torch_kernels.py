"""The port's kernel modules against the JAX reference, on the CPU.

On the CPU each wrapper of :mod:`repro_torch.kernels` runs its plain
PyTorch version (the CUDA kernels themselves are held against those plain
versions on the card by ``chip_smoke.py``).  Here the plain versions meet
the JAX package: the Pallas kernels in interpret mode and the lax paths
they replace, on the same numpy inputs, in float32 with
``atol = rtol = 1e-5``.  Skipped pages must give the exact identities.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.paged_flash_decode import \
    paged_flash_decode_partials as jax_paged
from repro.models.attention import (_chunked_attention_local,
                                    _combine_page_partials, _page_partials)
from repro.models.common import paged_gather as jax_gather
from repro.models.common import paged_scatter as jax_scatter
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_flash_decode as pfd
from repro_torch.models import attention as tattn
from repro_torch.models.common import paged_gather, paged_scatter

TOL = dict(atol=1e-5, rtol=1e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _flash_inputs(seed, b, s, h, kv, dh):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, s, n, dh).astype(np.float32) for n in (h, kv, kv)]


# -- causal flash forward -----------------------------------------------------

@pytest.mark.parametrize("kv", [4, 1])          # G = 1 (MHA), G = 4 (GQA)
@pytest.mark.parametrize("kv_valid", [None, 11])
def test_flash_plain_matches_pallas_interpret(kv, kv_valid):
    q, k, v = _flash_inputs(0, 2, 16, 4, kv, 16)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     bq=8, bk=8, kv_valid=kv_valid, interpret=True)
    got = fa.flash_attention(_t(q), _t(k), _t(v), kv_valid=kv_valid)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("s", [16, 13, 1])      # ragged chunk lengths too
@pytest.mark.parametrize("kv", [4, 1])
def test_flash_plain_matches_chunked_attention(s, kv):
    q, k, v = _flash_inputs(1, 3, s, 4, kv, 8)
    want = _chunked_attention_local(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), jnp.int32(0),
                                    jnp.int32(s))
    got = fa.flash_attention(_t(q), _t(k), _t(v), kv_valid=s)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_flash_wrapper_validates_inputs():
    q = torch.zeros(1, 4, 4, 8)
    with pytest.raises(ValueError):
        fa.flash_attention(q, torch.zeros(1, 4, 3, 8), torch.zeros(1, 4, 3, 8))
    with pytest.raises(TypeError):
        h = q.half()
        fa.flash_attention(h, h[:, :, :2], h[:, :, :2])


# -- paged flash-decode partials ---------------------------------------------

def _paged_case(seed, b, sq, kv, g, dh, n_pages, p, ps):
    """Random pool, permuted per-slot tables with -1 holes, and one fully
    inactive slot (empty table, position -1, kv_valid 0)."""
    rng = np.random.RandomState(seed)
    kp = rng.randn(n_pages, ps, kv, dh).astype(np.float32)
    vp = rng.randn(n_pages, ps, kv, dh).astype(np.float32)
    q = rng.randn(b, sq, kv * g, dh).astype(np.float32)
    tbl = np.full((b, p), -1, np.int32)
    perm = rng.permutation(n_pages)
    k = 0
    for i in range(b):
        n_mapped = rng.randint(1, p + 1)
        for j in range(n_mapped):
            tbl[i, j] = perm[k % n_pages]
            k += 1
        if n_mapped > 1:                         # a hole mid-table
            tbl[i, rng.randint(n_mapped)] = -1
    last = np.array([rng.randint(0, p * ps) for _ in range(b)], np.int32)
    tbl[-1] = -1
    last[-1] = -1
    qpos = (last[:, None] - np.arange(sq)[::-1][None, :]).astype(np.int32)
    kvv = np.maximum(last + 1, 0).astype(np.int32)
    return kp, vp, q, tbl, qpos, kvv


CASES = [(sq, g) for sq in (1, 5) for g in (1, 4)]


@pytest.mark.parametrize("sq,g", CASES)
def test_paged_plain_matches_pallas_interpret(sq, g):
    for seed in range(2):
        case = _paged_case(seed, b=3, sq=sq, kv=2, g=g, dh=16, n_pages=12,
                           p=4, ps=4)
        want = jax_paged(*[jnp.asarray(a) for a in case], interpret=True)
        got = pfd.paged_flash_decode_partials(*[_t(a) for a in case])
        for gt, wt in zip(got, want):
            np.testing.assert_allclose(gt.numpy(), np.asarray(wt), **TOL)


@pytest.mark.parametrize("sq,g", CASES)
def test_paged_plain_matches_lax_partials_and_combine(sq, g):
    kp, vp, q, tbl, qpos, kvv = _paged_case(
        3, b=3, sq=sq, kv=2, g=g, dh=16, n_pages=12, p=4, ps=4)
    jt = jnp.asarray(tbl)
    want = _page_partials(jnp.asarray(q), jax_gather(jnp.asarray(kp), jt),
                          jax_gather(jnp.asarray(vp), jt), jt,
                          jnp.asarray(qpos), jnp.asarray(kvv))
    got = pfd.paged_flash_decode_partials(_t(kp), _t(vp), _t(q), _t(tbl),
                                          _t(qpos), _t(kvv))
    for gt, wt in zip(got, want):
        np.testing.assert_allclose(gt.numpy(), np.asarray(wt), **TOL)
    # skipped pages: the exact identities, bit for bit
    skip = np.asarray(want[0]) <= -1e30
    assert skip.any()
    assert (got[0].numpy()[skip] == -1e30).all()
    assert (got[1].numpy()[skip] == 0).all()
    assert (got[2].numpy()[skip] == 0).all()
    np.testing.assert_allclose(
        tattn._combine_page_partials(*got).numpy(),
        np.asarray(_combine_page_partials(*want)), **TOL)


@pytest.mark.parametrize("pages_per_split", [2, 3, 4])
def test_paged_splits_combine_to_per_page_result(pages_per_split):
    case = [_t(a) for a in _paged_case(4, b=3, sq=5, kv=2, g=2, dh=16,
                                       n_pages=12, p=4, ps=4)]
    per_page = pfd.paged_flash_decode_partials(*case)
    split = pfd.paged_flash_decode_partials(*case,
                                            pages_per_split=pages_per_split)
    assert split[0].shape[-1] == -(-4 // pages_per_split)
    np.testing.assert_allclose(
        tattn._combine_page_partials(*split).numpy(),
        tattn._combine_page_partials(*per_page).numpy(), atol=1e-6, rtol=1e-6)


def test_pages_per_split_bounds_partials_memory():
    # decode at serving width stays per page; a resumed 256-row chunk
    # over 128 pages walks several pages per block
    assert tattn._pages_per_split(8, 1, 16, 128, 128) == 1
    c = tattn._pages_per_split(8, 256, 16, 128, 128)
    n_split = -(-128 // c)
    assert c > 1 and 8 * 256 * 16 * n_split * 128 * 4 <= \
        tattn.PARTIALS_BYTES_BUDGET


def test_paged_wrapper_validates_inputs():
    kp, vp, q, tbl, qpos, kvv = [_t(a) for a in _paged_case(
        5, b=2, sq=1, kv=2, g=2, dh=8, n_pages=4, p=2, ps=4)]
    with pytest.raises(TypeError):
        pfd.paged_flash_decode_partials(kp, vp, q, tbl.long(), qpos, kvv)
    with pytest.raises(ValueError):
        pfd.paged_flash_decode_partials(kp, vp, q, tbl, qpos[:, :0], kvv)


# -- pool addressing ----------------------------------------------------------

def test_paged_scatter_and_gather_match_reference():
    rng = np.random.RandomState(6)
    pool = rng.randn(6, 4, 2, 3).astype(np.float32)
    pages = np.array([[2, -1, 5], [0, 1, -1]], np.int32)
    rows = rng.randn(2, 5, 2, 3).astype(np.float32)
    t = np.array([[0, 3, 4, 9, 12], [-1, 2, 7, 8, 11]], np.int32)
    valid = np.array([[1, 1, 1, 1, 1], [1, 1, 1, 0, 1]], bool)
    want = jax_scatter(jnp.asarray(pool), jnp.asarray(pages),
                       jnp.asarray(rows), jnp.asarray(t), jnp.asarray(valid))
    got = paged_scatter(_t(pool.copy()), _t(pages), _t(rows), _t(t),
                        _t(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        paged_gather(got, _t(pages)).numpy(),
        np.asarray(jax_gather(want, jnp.asarray(pages))))
