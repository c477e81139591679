"""MLA decode's split of the page axis against the JAX reference, on the
CPU.

The port's MLA decode cuts each slot's pages into splits of one 64-key
tile of the bf16 kernel (``models/attention.py::tile_pages_per_split``,
which ``models/mla.py::decode_split`` takes: 4 pages at page 16, 2 at
page 32), where the reference takes one page a
split.  The function depends on the page size and the table width alone,
so the CPU runs the card's split.  Here:

  * the split itself, at the page sizes the engine serves and at tables
    narrower than a tile;
  * at that split, with several splits a slot, the plain partials
    combine to the JAX package's per-page result (the Pallas body in
    interpret mode, then the reference's combine) within ``atol=1e-5``
    in float32, on an fp and an int8 latent pool;
  * a tiny float32 MLA engine whose decode walks several splits gives
    the JAX engine's tokens, completion order, counters and TTFT ticks,
    and its logits within ``atol=1e-5``.
"""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.pageformat import get_format as jax_format
from repro.kernels.paged_flash_decode import \
    mla_paged_decode_partials as jax_mla
from repro.models import ArchConfig as JaxCfg
from repro.models import init_params as jax_init_params
from repro.models.attention import _combine_page_partials as jax_combine
from repro.serve import Request as JaxRequest
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import ServingEngine as JaxEngine
from repro_torch.kernels import paged_flash_decode as pfd
from repro_torch.models import attention as tattn
from repro_torch.models import mla
from repro_torch.models.config import ArchConfig
from repro_torch.serve import Request, ServeConfig, ServingEngine
from repro_torch.weights import from_jax_numpy

TOL = dict(atol=1e-5, rtol=0)
R, DR, H, PS, P, N = 32, 8, 4, 16, 10, 32
SCALE_DIM = 16 + DR                     # qk_nope + qk_rope of the mla config


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
    assert tattn.tile_pages_per_split(page_size, p) == want
    assert pfd.TILE_KEYS == 64


def test_the_decode_split_reads_no_device_or_config():
    """Two arguments, page size and table width: the CPU and the card cut
    the page axis alike."""
    params = inspect.signature(tattn.tile_pages_per_split).parameters
    assert list(params) == ["page_size", "p"]


@pytest.mark.parametrize("b,p,want", [
    (8, 128, 4), (32, 256, 4),          # serving traffic: one tile a split
    (8, 2048, 8), (32, 2048, 32),       # 32 k tokens: the budget raises it
])
def test_the_budget_caps_the_decode_partials(b, p, want):
    """At deepseek-v2-lite's widths (H 16, r 512, page 16) decode takes one
    tile a split until its float32 partials would pass
    PARTIALS_BYTES_BUDGET; past that the split grows as the GQA kernels'
    does, and the partials stay within the budget."""
    c = mla.decode_split(16, b, 1, 16, p, 512)
    assert c == want
    assert b * 16 * -(-p // c) * 512 * 4 <= tattn.PARTIALS_BYTES_BUDGET


def _case(seed, b=4):
    """A latent pool at page 16 with P 10 pages a slot (three splits of
    4, the last one short): slot 0 has a hole and a partly filled last
    page, slot 1 maps a page wholly past its position and reaches the
    second split, slot 2 is full to its last row (every split live), and
    slot 3 is inactive (empty table, position -1)."""
    rng = np.random.RandomState(seed)
    pool = rng.randn(N, PS, R + DR).astype(np.float32)
    qc = rng.randn(b, 1, H, R).astype(np.float32)
    qr = rng.randn(b, 1, H, DR).astype(np.float32)
    perm = rng.permutation(N)
    tbl = np.full((b, P), -1, np.int32)
    tbl[0, :5] = perm[:5]
    tbl[0, 2] = -1                                   # hole mid-table
    tbl[1, :7] = perm[5:12]                          # page 6 past pos 90
    tbl[2, :] = perm[12:22]
    pos = np.array([70, 90, P * PS - 1, -1], np.int32)[:b]
    return pool, qc, qr, tbl, pos


@pytest.mark.parametrize("fmt", [None, "int8"])
@pytest.mark.parametrize("seed", [0, 1])
def test_the_split_combines_to_the_reference_per_page_result(fmt, seed):
    pool, qc, qr, tbl, pos = _case(seed)
    quant, jquant = {}, {}
    if fmt is not None:
        q, s = jax_format(fmt).quantize_rows(jnp.asarray(pool))
        pool = np.asarray(q)
        quant = dict(scale_pool=_t(np.asarray(s)), bits=jax_format(fmt).bits)
        jquant = dict(scale_pool=s, bits=jax_format(fmt).bits)
    want = jax_mla(*[jnp.asarray(a) for a in (pool, qc, qr, tbl, pos)], R,
                   SCALE_DIM, interpret=True, **jquant)
    c = tattn.tile_pages_per_split(PS, P)
    got = pfd.mla_paged_decode_partials(
        *[_t(a) for a in (pool, qc, qr, tbl, pos)], R, SCALE_DIM,
        pages_per_split=c, **quant)
    assert c == 4 and got[0].shape[-1] == 3 and want[0].shape[-1] == P
    np.testing.assert_allclose(tattn._combine_page_partials(*got).numpy(),
                               np.asarray(jax_combine(*want)), **TOL)
    # the inactive slot's splits stay the exact identities
    assert (got[0][3] == -1e30).all() and (got[1][3] == 0).all()
    assert (got[2][3] == 0).all()


MLA = dict(name="split_mla", family="dense", n_layers=2, d_model=64,
           n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=100,
           kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
           decode_margin=32, pattern=(("scan", "mla_mlp", 2),))
# page 16 and 6 pages a slot: decode takes 2 splits of 4 pages, and the
# longer requests' positions pass 64, into the second split
SERVE = dict(max_batch=3, max_prompt=32, max_new_tokens=6, page_size=16,
             max_seq=96, record_logits=True)
COUNTERS = ["n_cow_copies", "n_shared_admissions", "n_preemptions",
            "peak_active", "tick_no"]


def _prompts():
    rng = np.random.RandomState(11)
    return [[int(t) for t in rng.randint(0, 100, n)]
            for n in (70, 9, 66, 40, 3, 75)]


def _port_run(tc, tp, prompts):
    """The port's engine over ``prompts``, recording each decode call's
    (pages a split, table width, top position)."""
    calls = []
    good = mla.mla_paged_decode_partials

    def spy(pool, q_c, q_rope, tbl, pos, r, scale_dim, **kw):
        calls.append((kw["pages_per_split"], tbl.shape[1],
                      int(pos.max())))
        return good(pool, q_c, q_rope, tbl, pos, r, scale_dim, **kw)
    mla.mla_paged_decode_partials = spy
    try:
        te = ServingEngine(tc, tp, ServeConfig(**SERVE), device="cpu")
        tout = te.run([Request(i, p) for i, p in enumerate(prompts)])
    finally:
        mla.mla_paged_decode_partials = good
    return te, {r.rid: r for r in tout}, calls


@pytest.fixture(scope="module")
def engines():
    jc = JaxCfg(**MLA, dtype=jnp.float32)
    tc = ArchConfig(**MLA, dtype=torch.float32)
    jp = jax_init_params(jc, jax.random.PRNGKey(3))
    tp = from_jax_numpy(tc, jax.tree.map(np.asarray, jp), device="cpu")
    prompts = _prompts()
    je = JaxEngine(jc, jp, JaxServeConfig(**SERVE))
    jout = je.run([JaxRequest(i, p) for i, p in enumerate(prompts)])
    te, tout, calls = _port_run(tc, tp, prompts)
    return {"jax": je, "port": te, "calls": calls, "cfg": tc, "params": tp,
            "jout": {r.rid: r for r in jout}, "tout": tout}


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


def test_the_engine_decode_keeps_the_budget(engines, monkeypatch):
    """With a partials budget too small for one tile a split, the engine's
    decode takes the budget's split (all 6 pages in one split, i.e. an
    online softmax across two tiles) and still gives the JAX engine's
    tokens and logits."""
    b, h, r = SERVE["max_batch"], MLA["n_heads"], MLA["kv_lora_rank"]
    monkeypatch.setattr(tattn, "PARTIALS_BYTES_BUDGET", b * h * r * 4)
    assert mla.decode_split(16, b, 1, h, 6, r) == 6
    _, tout, calls = _port_run(engines["cfg"], engines["params"], _prompts())
    assert {(c, p) for c, p, _ in calls} == {(6, 6)}
    for rid, ref in engines["jout"].items():
        assert tout[rid].out_tokens == ref.out_tokens, rid
        for a, b_ in zip(tout[rid].logits, ref.logits):
            np.testing.assert_allclose(a, np.asarray(b_), **TOL)
