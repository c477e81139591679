"""The port's contiguous serving engine against the JAX one, on the CPU.

``ServeConfig(paged=False)``: one engine of each package serves the same
requests on the same bridged float32 weights with ``record_logits=True``
(more requests than slots, prompts up to the chunk), for a G 2 dense
config and the ``mla`` family config.  Tokens, completion order, the
counters and TTFT ticks must be equal and every per-token logit within
``atol=1e-5``.  The IOTLB: a span past the slot's window is recorded and
rejected by a non-strict engine, and raises from a strict one, with the
reference's fault records.  The port's contiguous engine must give its
paged engine's tokens (the reference's ``test_paged_cache.py::
test_paged_engine_matches_contiguous_engine``), and at the same page
size and no prefix sharing the same logits bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.iotlb import IotlbFault as JaxIotlbFault
from repro.models import ArchConfig as JaxCfg
from repro.models import init_params as jax_init_params
from repro.serve import Request as JaxRequest
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import ServingEngine as JaxEngine
from repro_torch.core.iotlb import IotlbFault
from repro_torch.models.config import ArchConfig
from repro_torch.serve import Request, ServeConfig, ServingEngine
from repro_torch.weights import from_jax_numpy

BASE = dict(family="dense", n_layers=2, d_model=64, n_heads=4, d_ff=128,
            vocab_size=100, decode_margin=32)
FIELDS = {
    "dense": dict(BASE, name="cs_g2", n_kv_heads=2),
    "mla": dict(BASE, name="cs_mla", n_kv_heads=4, kv_lora_rank=32,
                qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
                pattern=(("scan", "mla_mlp", 2),)),
}
SERVE = dict(paged=False, max_batch=3, max_prompt=12, max_new_tokens=6,
             page_size=4, record_logits=True)
COUNTERS = ["n_cow_copies", "n_shared_admissions", "n_preemptions",
            "peak_active", "tick_no"]


def _models(name, seed=0):
    jc = JaxCfg(**FIELDS[name], dtype=jnp.float32)
    tc = ArchConfig(**FIELDS[name], dtype=torch.float32)
    jp = jax_init_params(jc, jax.random.PRNGKey(seed))
    tp = from_jax_numpy(tc, jax.tree.map(np.asarray, jp), device="cpu")
    return jc, tc, jp, tp


def _prompts():
    rng = np.random.RandomState(7)
    return [[int(t) for t in rng.randint(0, 100, n)]
            for n in (12, 3, 9, 1, 7, 12, 5)]


@pytest.fixture(scope="module", params=sorted(FIELDS))
def engines(request):
    jc, tc, jp, tp = _models(request.param)
    prompts = _prompts()
    je = JaxEngine(jc, jp, JaxServeConfig(**SERVE))
    jout = je.run([JaxRequest(i, p) for i, p in enumerate(prompts)])
    te = ServingEngine(tc, tp, ServeConfig(**SERVE), device="cpu")
    te.warmup()
    assert all(float(v.abs().sum()) == 0 for v in te.cache[0].values())
    handles = [te.submit(Request(i, p)) for i, p in enumerate(prompts)]
    tdone = te.drain()
    return {"jax": je, "port": te, "prompts": prompts, "handles": handles,
            "jout": {r.rid: r for r in jout},
            "tout": {r.rid: r for r in tdone}}


def test_every_request_completes(engines):
    assert sorted(engines["tout"]) == list(range(len(engines["prompts"])))
    for h in engines["handles"]:
        assert h.status == "done"
        assert len(h.tokens_so_far) == SERVE["max_new_tokens"]
    st = engines["port"].stats()
    assert st["kernel_launches"] == 0          # CPU: plain versions only
    assert st["peak_pages"] == 0 and engines["port"].alloc is None


def test_tokens_equal_reference(engines):
    for rid, ref in engines["jout"].items():
        assert engines["tout"][rid].out_tokens == ref.out_tokens, rid


def test_completion_order_equals_reference(engines):
    assert [r.rid for r in engines["jax"].completed] == \
        [r.rid for r in engines["port"].completed]


def test_logits_match_reference(engines):
    for rid, ref in engines["jout"].items():
        got = engines["tout"][rid].logits
        assert len(got) == len(ref.logits) == SERVE["max_new_tokens"]
        for a, b in zip(got, ref.logits):
            np.testing.assert_allclose(a, np.asarray(b), atol=1e-5, rtol=0)


@pytest.mark.parametrize("counter", COUNTERS)
def test_counters_equal_reference(engines, counter):
    assert getattr(engines["port"], counter) == \
        getattr(engines["jax"], counter)


def test_ttft_ticks_equal_reference(engines):
    for rid, ref in engines["jout"].items():
        assert engines["tout"][rid].ttft_ticks == ref.ttft_ticks, rid


def _faults(eng):
    return [(f.kind, f.start, f.length, f.write) for f in eng.iotlb.faults]


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_nonstrict_iotlb_rejects_an_over_capacity_span(name):
    """A prompt longer than the chunk spans past the slot's window: a
    non-strict engine records the miss and rejects it, and serves the
    rest, as the reference's."""
    jc, tc, jp, tp = _models(name)
    sc = dict(SERVE, strict_iotlb=False)
    prompts = [[5, 7, 11], list(range(1, 16)), [2, 7]]
    jout = JaxEngine(jc, jp, JaxServeConfig(**sc))
    jdone = {r.rid: r for r in jout.run(
        [JaxRequest(i, p) for i, p in enumerate(prompts)])}
    te = ServingEngine(tc, tp, ServeConfig(**sc), device="cpu")
    tdone = {r.rid: r for r in te.run(
        [Request(i, p) for i, p in enumerate(prompts)])}
    assert tdone[1].failed and tdone[1].done and tdone[1].out_tokens == []
    assert _faults(te) == _faults(jout) == [("miss", 18, 21, True)]
    for rid in (0, 2):
        assert not tdone[rid].failed
        assert tdone[rid].out_tokens == jdone[rid].out_tokens


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_strict_iotlb_raises_on_an_over_capacity_span(name):
    jc, tc, jp, tp = _models(name)
    bad = list(range(1, 20))
    je = JaxEngine(jc, jp, JaxServeConfig(**SERVE))
    jr = JaxRequest(3, bad)
    je.submit(jr)
    with pytest.raises(JaxIotlbFault, match="request 3"):
        je.tick()
    te = ServingEngine(tc, tp, ServeConfig(**SERVE), device="cpu")
    tr = Request(3, bad)
    te.submit(tr)                   # no oversized rejection at submit
    with pytest.raises(IotlbFault, match="request 3"):
        te.tick()
    assert tr.failed and tr.done and jr.failed
    assert _faults(te) == _faults(je) == [("miss", 0, 25, True)]


def test_iotlb_programs_one_whole_slot_window_a_slot():
    _, tc, _, tp = _models("dense")
    te = ServingEngine(tc, tp, ServeConfig(**SERVE), device="cpu")
    rows = SERVE["max_prompt"] + SERVE["max_new_tokens"]
    assert [(w.virt_base, w.size) for w in te.iotlb.windows] == \
        [(i * rows, rows) for i in range(SERVE["max_batch"])]
    assert te.cache[0]["k"].shape[2] == 256        # 18 + 32, rounded up


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_contiguous_engine_matches_paged_engine(name):
    """The reference's paged-vs-contiguous engine check, on the port: the
    paged engine with small pages (slot reuse, on-demand growth) gives
    the contiguous engine's tokens; at the contiguous engine's page size
    with no prefix sharing, its logits bit for bit."""
    _, tc, _, tp = _models(name)
    prompts = [[5, 7, 11], [3, 1, 4, 1, 5, 9, 2, 6], [2, 7],
               [9, 8, 7, 6, 5]]
    base = dict(max_batch=2, max_prompt=16, max_new_tokens=5,
                record_logits=True)

    def run(**kw):
        eng = ServingEngine(tc, tp, ServeConfig(**base, **kw), device="cpu")
        out = eng.run([Request(i, list(p)) for i, p in enumerate(prompts)])
        return {r.rid: r for r in out}, eng

    contig, _ = run(paged=False)
    paged, eng = run(paged=True, page_size=4)
    assert {r: q.out_tokens for r, q in paged.items()} == \
        {r: q.out_tokens for r, q in contig.items()}
    assert eng.pages_in_use() == 0 and (eng.alloc.page_table == -1).all()
    contig4, _ = run(paged=False, page_size=4)
    twin, _ = run(paged=True, page_size=4, prefix_sharing=False)
    for rid, r in contig4.items():
        assert np.array_equal(np.stack(r.logits), np.stack(twin[rid].logits))


def test_page_size_must_divide_the_contiguous_cache():
    """A page size that does not divide the cache's capacity (24 against
    256 rows a slot) is served, as by the reference's contiguous engine,
    which reads no page size: decode views the cache through pages of
    its own.  Tokens, completion order, counters and TTFT ticks are the
    JAX contiguous engine's, logits within 1e-5."""
    jc, tc, jp, tp = _models("dense")
    sc = dict(SERVE, page_size=24)
    prompts = _prompts()
    je = JaxEngine(jc, jp, JaxServeConfig(**sc))
    jout = {r.rid: r for r in je.run(
        [JaxRequest(i, p) for i, p in enumerate(prompts)])}
    te = ServingEngine(tc, tp, ServeConfig(**sc), device="cpu")
    assert te.cache[0]["k"].shape[2] % 24 != 0
    tout = {r.rid: r for r in te.run(
        [Request(i, p) for i, p in enumerate(prompts)])}
    assert sorted(tout) == sorted(jout) == list(range(len(prompts)))
    for rid, ref in jout.items():
        assert tout[rid].out_tokens == ref.out_tokens, rid
        assert tout[rid].ttft_ticks == ref.ttft_ticks, rid
        for a, b in zip(tout[rid].logits, ref.logits):
            np.testing.assert_allclose(a, np.asarray(b), atol=1e-5, rtol=0)
    assert [r.rid for r in te.completed] == [r.rid for r in je.completed]
    for counter in COUNTERS:
        assert getattr(te, counter) == getattr(je, counter), counter
