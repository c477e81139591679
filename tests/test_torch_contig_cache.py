"""The port's contiguous cache layout against the JAX reference, on the CPU.

The reference's ``paged=False`` layout keeps one (cap, ...) region a slot
per layer.  Its writes are held bitwise: ``contig_scatter`` (invalid,
negative and ``t >= cap`` rows dropped), ``cache_fill`` (a slot of
length 0 untouched) and ``cache_update`` (a negative index writes
nothing), each on the same numpy buffers in both packages.
``init_cache`` must give the reference's leaves and shapes
(``cache_capacity``'s rounding to 256 included), ``contig_pages`` a
view of the same storage and the identity table, and the four
contiguous step makers the reference's logits and caches within
``atol=1e-5``.  ``ServeConfig(paged=False)`` rejects each field the
reference rejects, under the same name.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ArchConfig as JaxCfg
from repro.models.model import cache_capacity as jax_cache_capacity
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models.attention import cache_fill as jax_cache_fill
from repro.models.attention import cache_update as jax_cache_update
from repro.models.common import contig_scatter as jax_contig_scatter
from repro.serve import ServeConfig as JaxServeConfig
from repro.train.step import make_chunked_prefill_resume_step as jax_resume
from repro.train.step import make_chunked_prefill_step as jax_chunk
from repro.train.step import make_decode_step as jax_decode
from repro.train.step import make_prefill_step as jax_prefill
from repro_torch.models.attention import (apply_attention, cache_fill,
                                          cache_update)
from repro_torch.models.common import ContigView, contig_pages, contig_scatter
from repro_torch.models.config import ArchConfig
from repro_torch.models.model import (cache_capacity, forward, init_cache,
                                      init_paged_cache)
from repro_torch.serve import ServeConfig
from repro_torch.train.step import (make_chunked_prefill_resume_step,
                                    make_chunked_prefill_step,
                                    make_decode_step, make_prefill_step)
from repro_torch.weights import from_jax_numpy
from torch_dense_cases import configs

ATOL = 1e-5
DENSE = dict(name="cb", family="dense", n_layers=2, d_model=64, n_heads=4,
             n_kv_heads=2, d_ff=128, vocab_size=100, decode_margin=32)
MLA = dict(name="srv_mla", family="dense", n_layers=2, d_model=64,
           n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=100,
           kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
           decode_margin=32, pattern=(("scan", "mla_mlp", 2),))
CAP = 16


def _pair(fields):
    return (JaxCfg(**fields, dtype=jnp.float32),
            ArchConfig(**fields, dtype=torch.float32))


def _same_bits(want, got):
    want = np.asarray(want)
    assert want.dtype == got.dtype and want.shape == got.shape
    assert want.tobytes() == got.tobytes()


# -- the writes, bitwise --------------------------------------------------------

# (name, per-slot positions, per-slot valid counts): one consecutive chunk
# a slot, as a resumed chunk writes them
SCATTERS = {
    "in_window": ([0, 5, 9], [4, 4, 2]),
    "past_cap": ([13, 2, 15], [4, 3, 4]),      # rows at t >= cap dropped
    "negative": ([-2, 0, -4], [4, 2, 3]),      # rows at t < 0 dropped
    "inactive": ([3, 7, 0], [0, 4, 0]),        # length 0: nothing written
}


@pytest.mark.parametrize("rest", [(2, 3), (5,)], ids=["kv", "latent"])
@pytest.mark.parametrize("case", sorted(SCATTERS))
def test_contig_scatter_bitwise_equals_reference(case, rest):
    starts, lens = SCATTERS[case]
    rng = np.random.RandomState(1)
    b, s = 3, 4
    buf = rng.randn(b, CAP, *rest).astype(np.float32)
    rows = rng.randn(b, s, *rest).astype(np.float32)
    t = (np.array(starts)[:, None] + np.arange(s)[None]).astype(np.int32)
    valid = np.arange(s)[None] < np.array(lens)[:, None]
    want = jax_contig_scatter(jnp.asarray(buf), jnp.asarray(rows),
                              jnp.asarray(t), jnp.asarray(valid))
    got = torch.from_numpy(buf.copy())
    out = contig_scatter(got, torch.from_numpy(rows), torch.from_numpy(t),
                         torch.from_numpy(valid))
    assert out is got                          # written in place
    _same_bits(want, got.numpy())


def test_contig_scatter_rejects_more_rows_than_the_cache():
    buf = torch.zeros((1, 4, 2))
    with pytest.raises(ValueError, match="more than the cache"):
        contig_scatter(buf, torch.zeros((1, 5, 2)),
                       torch.zeros((1, 5), dtype=torch.int32),
                       torch.ones((1, 5), dtype=torch.bool))


@pytest.mark.parametrize("lens", [[4, 0, 2], [0, 0, 0], [4, 4, 4]])
def test_cache_fill_bitwise_equals_reference(lens):
    rng = np.random.RandomState(2)
    b, s = 3, 4
    cache = {k: rng.randn(b, CAP, 2, 3).astype(np.float32) for k in "kv"}
    k_new, v_new = (rng.randn(b, s, 2, 3).astype(np.float32)
                    for _ in range(2))
    lens = np.array(lens, np.int32)
    want = jax_cache_fill({k: jnp.asarray(v) for k, v in cache.items()},
                          jnp.asarray(k_new), jnp.asarray(v_new),
                          jnp.asarray(lens))
    got = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    cache_fill(got, torch.from_numpy(k_new), torch.from_numpy(v_new),
               torch.from_numpy(lens))
    for k in "kv":
        _same_bits(want[k], got[k].numpy())
    # the slot of length 0 keeps its rows, the rows past len theirs
    assert np.array_equal(got["k"].numpy()[lens == 0],
                          cache["k"][lens == 0])


@pytest.mark.parametrize("index", [[3, -1, 15], [0, 7, -5], [16, 2, 20]],
                         ids=["inactive", "negative", "past_cap"])
def test_cache_update_bitwise_equals_reference(index):
    rng = np.random.RandomState(3)
    b = 3
    cache = {k: rng.randn(b, CAP, 2, 3).astype(np.float32) for k in "kv"}
    k_new, v_new = (rng.randn(b, 1, 2, 3).astype(np.float32)
                    for _ in range(2))
    index = np.array(index, np.int32)
    want = jax_cache_update({k: jnp.asarray(v) for k, v in cache.items()},
                            jnp.asarray(k_new), jnp.asarray(v_new),
                            jnp.asarray(index))
    got = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    cache_update(got, torch.from_numpy(k_new), torch.from_numpy(v_new),
                 torch.from_numpy(index))
    for k in "kv":
        _same_bits(want[k], got[k].numpy())


# -- layout -------------------------------------------------------------------

@pytest.mark.parametrize("prompt_len", [1, 8, 224, 225, 1000])
@pytest.mark.parametrize("name", ["g2", "qkn", "mla", "qwen2.5-3b"])
def test_init_cache_keeps_reference_layout(name, prompt_len):
    if name == "g2":
        jc, tc = _pair(DENSE)
    elif name == "mla":
        jc, tc = _pair(MLA)
    elif name == "qkn":
        jc, tc = configs("g4")
    else:
        jc, tc = configs(name)
    assert cache_capacity(tc, prompt_len) == \
        jax_cache_capacity(jc, prompt_len)
    want = jax_init_cache(jc, 3, prompt_len)
    got = init_cache(tc, 3, prompt_len, device="cpu")
    assert [{k: (v.shape, str(v.dtype)) for k, v in s.items()}
            for s in want] == \
        [{k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
          for k, v in s.items()} for s in got]
    assert all(float(v.abs().sum()) == 0 for s in got for v in s.values())


def test_contig_pages_is_a_view_with_the_identity_table():
    buf = torch.arange(2 * 32 * 3, dtype=torch.float32).reshape(2, 32, 3)
    (pool,), tbl = contig_pages((buf,), ContigView(page_size=4, rows=10))
    assert pool.shape == (16, 4, 3)
    assert pool.data_ptr() == buf.data_ptr()        # no copy
    assert tbl.dtype == torch.int32
    assert tbl.tolist() == [[0, 1, 2], [8, 9, 10]]  # ceil(10 / 4) pages
    assert torch.equal(pool[tbl[1, 2]], buf[1, 8:12])
    (_,), whole = contig_pages((buf,), None)        # page 16, every row
    assert whole.tolist() == [[0, 1], [2, 3]]
    with pytest.raises(ValueError, match="does not divide"):
        contig_pages((buf,), ContigView(page_size=5))


@pytest.mark.parametrize("mode,item", [("train", "item 16"),
                                       ("verify", "item 14")])
def test_unported_modes_raise_naming_their_item(mode, item):
    jc, tc = _pair(DENSE)
    layer = {k: v[0] for k, v in init_cache(tc, 1, 4, device="cpu")[0]
             .items()}
    tp = from_jax_numpy(tc, jax.tree.map(np.asarray, jax_init_params(
        jc, jax.random.PRNGKey(0))), device="cpu")
    with pytest.raises(ValueError, match=item):
        apply_attention(tp.blocks[0].attn, torch.zeros((1, 4, 64)), tc,
                        cache=layer, mode=mode, pos=0)
    with pytest.raises(ValueError, match="item 16"):
        forward(tp, torch.zeros((1, 4), dtype=torch.int32), tc, cache=None,
                mode="train")


def test_prefill_mode_rejects_a_paged_cache():
    jc, tc = _pair(DENSE)
    tp = from_jax_numpy(tc, jax.tree.map(np.asarray, jax_init_params(
        jc, jax.random.PRNGKey(0))), device="cpu")
    with pytest.raises(ValueError, match="contiguous cache"):
        forward(tp, torch.zeros((1, 4), dtype=torch.int32), tc,
                cache=init_paged_cache(tc, 4, 4, device="cpu"),
                mode="prefill", pages=torch.zeros((1, 1), dtype=torch.int32))


# -- the four step makers -----------------------------------------------------

@pytest.fixture(scope="module", params=["g2", "mla"])
def steps(request):
    """Both packages' four contiguous steps in sequence on one cache each:
    'prefill' of a whole prompt, a fresh chunk (one slot inactive), a
    resumed chunk at per-slot offsets, two decode steps (one slot
    inactive).  Per step: (reference logits, port logits, reference
    cache leaves, port cache leaves), the logits of the active slots only:
    an inactive slot's are discarded by the engine, and an inactive MLA
    slot decodes to 0 in the port, to a masked mean in the reference
    (ROADMAP queue 3)."""
    jc, tc = _pair(DENSE if request.param == "g2" else MLA)
    tree = jax.tree.map(np.asarray, jax_init_params(jc,
                                                    jax.random.PRNGKey(1)))
    jp = jax.tree.map(jnp.asarray, tree)
    tp = from_jax_numpy(tc, tree, device="cpu")
    b, s, plen = 3, 6, 20
    rng = np.random.RandomState(5)
    jcache = jax_init_cache(jc, b, plen)
    tcache = init_cache(tc, b, plen, device="cpu")
    view = ContigView(page_size=4, rows=plen)
    toks = lambda n: rng.randint(0, 100, (b, n)).astype(np.int32)  # noqa
    lens1 = np.array([6, 0, 4], np.int32)
    lens2 = np.array([5, 6, 2], np.int32)
    offs = lens1.copy()
    pos = (lens1 + lens2).astype(np.int32)
    pos[2] = -1
    every = np.ones(b, bool)
    plan = [
        ("prefill", jax_prefill(jc), make_prefill_step(tc), (toks(8),),
         every),
        ("fresh", jax_chunk(jc), make_chunked_prefill_step(tc),
         (toks(s), lens1), lens1 > 0),
        ("resume", jax_resume(jc), make_chunked_prefill_resume_step(tc, view),
         (toks(s), lens2, offs), every),
        ("decode", jax_decode(jc), make_decode_step(tc, view),
         (toks(1), pos), pos >= 0),
        ("decode2", jax_decode(jc), make_decode_step(tc, view),
         (toks(1), pos + (pos >= 0)), pos >= 0),
    ]
    out = {}
    for name, jstep, tstep, args, active in plan:
        targs = [torch.from_numpy(a) for a in args]
        if name == "prefill":          # prefill(params, inputs, cache)
            jl, jcache = jstep(jp, jnp.asarray(args[0]), jcache)
            with torch.inference_mode():
                tl, tcache = tstep(tp, targs[0], tcache)
        else:
            jl, jcache = jstep(jp, jcache, *map(jnp.asarray, args))
            with torch.inference_mode():
                tl, tcache = tstep(tp, tcache, *targs)
        out[name] = (np.asarray(jl)[active], tl.numpy()[active],
                     {k: np.asarray(v) for k, v in jcache[0].items()},
                     {k: v.numpy().copy() for k, v in tcache[0].items()})
    return out


@pytest.mark.parametrize("step", ["prefill", "fresh", "resume", "decode",
                                  "decode2"])
def test_step_makers_match_reference(steps, step):
    want, got, jc, tc = steps[step]
    assert got.shape == want.shape and len(got) > 0
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert sorted(jc) == sorted(tc)
    for k in jc:
        np.testing.assert_allclose(tc[k], jc[k], atol=ATOL, rtol=0)


# -- ServeConfig(paged=False) -------------------------------------------------

# the reference's paged=False rejections, each under its field; the port
# rejects decode_sharing, spec_draft and host_pool_pages for either
# layout first (ROADMAP queue 1 item 14), under the same field
PAGED_FALSE_REJECTS = {
    "decode_sharing": dict(decode_sharing=True),
    "spec_draft": dict(spec_draft="self"),
    "host_pool_pages": dict(host_pool_pages=8),
    "kv_format": dict(kv_format="int8"),
    "max_seq": dict(max_seq=64),
}


@pytest.mark.parametrize("field", sorted(PAGED_FALSE_REJECTS))
def test_paged_false_rejections_match_reference(field):
    kw = dict(paged=False, **PAGED_FALSE_REJECTS[field])
    with pytest.raises(ValueError, match=f"ServeConfig.{field}"):
        JaxServeConfig(**kw)
    with pytest.raises(ValueError, match=f"ServeConfig.{field}"):
        ServeConfig(**kw)


def test_paged_false_is_served_with_the_reference_slot_rows():
    kw = dict(paged=False, max_prompt=24, max_new_tokens=5)
    assert ServeConfig(**kw).slot_rows == JaxServeConfig(**kw).slot_rows \
        == 29
