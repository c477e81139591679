"""GQA decode's split of the page axis against the JAX reference, on the
CPU.

The port's GQA decode (Sq x H / KV <= 16 query rows a KV head) cuts each
slot's pages into splits of one 64-key tile of the bf16 kernel
(``models/attention.py::page_split``: 4 pages at page 16, 2 at page 32,
more only where the float32 partials would pass PARTIALS_BYTES_BUDGET),
where the reference takes one page a split; chunks keep
``_pages_per_split``.  The function reads the rows, the page size, the
table width and the budget alone, so the CPU runs the card's split.
Here:

  * the split itself, at the page sizes the engine serves, at tables
    narrower than a tile, at the 16-row switch, and where the budget
    raises it;
  * at that split, with several splits a slot, the plain partials (fp,
    int8 and int4 pools; G 8 and G 1) combine to the JAX package's
    per-page result (the Pallas bodies in interpret mode, then the
    reference's combine) within ``atol=1e-5`` in float32;
  * a 2-layer float32 GQA engine whose decode walks two live splits a
    slot gives the JAX engine's tokens, completion order, counters and
    TTFT ticks, and its logits within ``atol=1e-5``.
"""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.pageformat import get_format as jax_format
from repro.kernels.paged_flash_decode import \
    paged_flash_decode_partials as jax_paged
from repro.models import ArchConfig as JaxCfg
from repro.models import init_params as jax_init_params
from repro.models.attention import _combine_page_partials as jax_combine
from repro.serve import Request as JaxRequest
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import ServingEngine as JaxEngine
from repro_torch.kernels import paged_flash_decode as pfd
from repro_torch.models import attention as tattn
from repro_torch.models.config import ArchConfig
from repro_torch.serve import Request, ServeConfig, ServingEngine
from repro_torch.weights import from_jax_numpy

TOL = dict(atol=1e-5, rtol=0)
KV, DH, PS, P, N = 2, 16, 16, 10, 48


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("page_size,p,want", [
    (16, 128, 4), (32, 128, 2),         # the engine's pages: one 64-key tile
    (16, 64, 4), (32, 256, 2),
    (16, 3, 3), (32, 1, 1),             # never more than the table
    (4, 10, 10), (8, 100, 8),
    (64, 8, 1), (128, 8, 1),            # at least one page
])
def test_the_decode_split_is_one_key_tile(page_size, p, want):
    """qwen2.5-3b's decode (B 8, Sq 1, H 16, KV 2, dv 128)."""
    assert tattn.tile_pages_per_split(page_size, p) == want
    assert tattn.page_split(8, 1, 16, 2, p, page_size, 128) == want
    assert pfd.TILE_KEYS == 64


def test_the_tile_reads_no_device_or_config():
    """The tile's pages take two arguments, page size and table width;
    the split adds the rows and widths its budget reads, and nothing of
    a device or a dtype: the CPU and the card cut the page axis alike."""
    assert list(inspect.signature(tattn.tile_pages_per_split).parameters) \
        == ["page_size", "p"]
    assert list(inspect.signature(tattn.page_split).parameters) == \
        ["b", "sq", "hq", "kv", "p", "page_size", "dv"]


@pytest.mark.parametrize("sq,hq,kv,tile", [
    (1, 16, 2, True),                   # G 8: 8 rows
    (2, 16, 2, True),                   # G 8: 16 rows, one whole m16 tile
    (3, 16, 2, False),                  # G 8: 24 rows, a chunk
    (16, 2, 2, True),                   # G 1: 16 rows
    (17, 2, 2, False),                  # G 1: 17 rows, a chunk
    (256, 16, 2, False),                # a resumed 256-row chunk
])
def test_rows_choose_the_split_at_the_kernel_switch(sq, hq, kv, tile):
    """Decode's tile split up to DECODE_ROWS = 16 query rows (the bf16
    kernel's decode route), ``_pages_per_split`` above, as before."""
    b, p, dv = 8, 128, 128
    got = tattn.page_split(b, sq, hq, kv, p, 16, dv)
    assert got == (tattn.tile_split(16, b, sq, hq, p, dv) if tile
                   else tattn._pages_per_split(b, sq, hq, p, dv))
    assert (got == 4) == tile
    assert tattn.DECODE_ROWS == 16


@pytest.mark.parametrize("b,p,want", [
    (8, 128, 4), (32, 256, 4),          # serving traffic: one tile a split
    (8, 8192, 8), (32, 2048, 8),        # 128 k / 32 k tokens: the budget
    (32, 4096, 16),
])
def test_the_budget_caps_the_decode_partials(b, p, want):
    """At qwen2.5-3b's widths (H 16, KV 2, dh 128, page 16) decode takes
    one tile a split until its float32 partials would pass
    PARTIALS_BYTES_BUDGET; past that the split grows as a chunk's does,
    and the partials stay within the budget."""
    c = tattn.page_split(b, 1, 16, KV, p, 16, 128)
    assert c == want
    assert b * 16 * -(-p // c) * 128 * 4 <= tattn.PARTIALS_BYTES_BUDGET


def _case(seed, g, sq, b=4):
    """A pool at page 16 with P 10 pages a slot (three splits of 4, the
    last one short): slot 0 has a hole and a partly filled last page,
    slot 1 maps a page wholly past its filled rows and reaches the second
    split, slot 2 is full to its last row (every split live), and slot 3
    is inactive (its pages mapped, nothing filled, positions -1).  The
    ``sq`` queries of a slot end at its last filled row."""
    rng = np.random.RandomState(seed)
    kf = rng.randn(N, PS, KV, DH).astype(np.float32)
    vf = rng.randn(N, PS, KV, DH).astype(np.float32)
    q = rng.randn(b, sq, KV * g, DH).astype(np.float32)
    perm = rng.permutation(N)
    tbl = np.full((b, P), -1, np.int32)
    tbl[0, :5] = perm[:5]
    tbl[0, 2] = -1                                   # hole mid-table
    tbl[1, :7] = perm[5:12]                          # page 6 past row 90
    tbl[2, :] = perm[12:22]
    tbl[3, :3] = perm[22:25]                         # inactive, mapped
    kvv = np.array([71, 91, P * PS, 0], np.int32)[:b]
    qpos = (kvv[:, None] - sq + np.arange(sq)[None, :]).astype(np.int32)
    qpos[3] = -1
    return kf, vf, q, tbl, qpos, kvv


@pytest.mark.parametrize("g,sq", [(8, 1), (8, 2), (1, 1), (1, 16)])
@pytest.mark.parametrize("fmt", [None, "int8", "int4"])
def test_the_split_combines_to_the_reference_per_page_result(fmt, g, sq):
    kf, vf, q, tbl, qpos, kvv = _case(7 + g + sq, g, sq)
    kp, vp, quant, jquant = kf, vf, {}, {}
    if fmt is not None:
        f = jax_format(fmt)
        kq, ks = f.quantize_rows(jnp.asarray(kf))
        vq, vs = f.quantize_rows(jnp.asarray(vf))
        kp, vp = np.asarray(kq), np.asarray(vq)
        quant = dict(k_scale=_t(np.asarray(ks)), v_scale=_t(np.asarray(vs)),
                     bits=f.bits)
        jquant = dict(k_scale=ks, v_scale=vs, bits=f.bits)
    want = jax_paged(*[jnp.asarray(a) for a in (kp, vp, q, tbl, qpos, kvv)],
                     interpret=True, **jquant)
    c = tattn.page_split(4, sq, KV * g, KV, P, PS, DH)
    got = pfd.paged_flash_decode_partials(
        *[_t(a) for a in (kp, vp, q, tbl, qpos, kvv)], pages_per_split=c,
        **quant)
    assert c == 4 and got[0].shape[-1] == 3 and want[0].shape[-1] == P
    np.testing.assert_allclose(tattn._combine_page_partials(*got).numpy(),
                               np.asarray(jax_combine(*want)), **TOL)
    # slot 1's last split sees nothing (its mapped page 6 is past its
    # rows); the inactive slot's splits all stay the exact identities
    m, l, acc = got
    assert (m[1, ..., 2] == -1e30).all() and (l[1, ..., 2] == 0).all()
    assert (m[3] == -1e30).all() and (l[3] == 0).all()
    assert (acc[3] == 0).all() and (acc[1, ..., 2, :] == 0).all()


GQA = dict(name="split_gqa", family="dense", n_layers=2, d_model=128,
           n_heads=8, n_kv_heads=1, d_ff=128, vocab_size=100,
           decode_margin=32)
# page 16 and 6 pages a slot: decode (G 8: 8 query rows) takes 2 splits of
# 4 pages, and the longer requests' positions pass 64, into the second
SERVE = dict(max_batch=3, max_prompt=32, max_new_tokens=6, page_size=16,
             max_seq=96, record_logits=True)
COUNTERS = ["n_cow_copies", "n_shared_admissions", "n_preemptions",
            "peak_active", "tick_no"]


def _prompts():
    rng = np.random.RandomState(11)
    return [[int(t) for t in rng.randint(0, 100, n)]
            for n in (70, 9, 66, 40, 3, 75)]


@pytest.fixture(scope="module")
def engines():
    jc = JaxCfg(**GQA, dtype=jnp.float32)
    tc = ArchConfig(**GQA, dtype=torch.float32)
    jp = jax_init_params(jc, jax.random.PRNGKey(5))
    tp = from_jax_numpy(tc, jax.tree.map(np.asarray, jp), device="cpu")
    prompts = _prompts()
    je = JaxEngine(jc, jp, JaxServeConfig(**SERVE))
    jout = je.run([JaxRequest(i, p) for i, p in enumerate(prompts)])
    calls = []
    good = tattn.paged_flash_decode_partials

    def spy(k_pool, v_pool, q, tbl, qpos, kv_valid, **kw):
        if q.shape[1] == 1:                          # a decode step
            calls.append((kw["pages_per_split"], tbl.shape[1],
                          int(qpos.max())))
        return good(k_pool, v_pool, q, tbl, qpos, kv_valid, **kw)
    tattn.paged_flash_decode_partials = spy
    try:
        te = ServingEngine(tc, tp, ServeConfig(**SERVE), device="cpu")
        tout = te.run([Request(i, p) for i, p in enumerate(prompts)])
    finally:
        tattn.paged_flash_decode_partials = good
    return {"jax": je, "port": te, "calls": calls,
            "jout": {r.rid: r for r in jout},
            "tout": {r.rid: r for r in tout}}


def test_the_engine_decode_walks_several_splits(engines):
    calls = engines["calls"]
    assert calls
    assert {(c, p) for c, p, _ in calls} == {(4, 6)}
    assert max(top for _, _, top in calls) >= 64       # a second split live


def test_tokens_and_completion_order_equal_reference(engines):
    for rid, ref in engines["jout"].items():
        assert engines["tout"][rid].out_tokens == ref.out_tokens, rid
    assert [r.rid for r in engines["jax"].completed] == \
        [r.rid for r in engines["port"].completed]


def test_logits_match_reference(engines):
    for rid, ref in engines["jout"].items():
        got = engines["tout"][rid].logits
        assert len(got) == len(ref.logits) == SERVE["max_new_tokens"]
        for a, b in zip(got, ref.logits):
            np.testing.assert_allclose(a, np.asarray(b), **TOL)


@pytest.mark.parametrize("counter", COUNTERS)
def test_counters_equal_reference(engines, counter):
    assert getattr(engines["port"], counter) == \
        getattr(engines["jax"], counter)


def test_ttft_ticks_equal_reference(engines):
    for rid, ref in engines["jout"].items():
        assert engines["tout"][rid].ttft_ticks == ref.ttft_ticks, rid
