"""The port's serving engine on quantized KV pools against the JAX
engine, on the CPU.

One engine of each package serves the same requests on the same bridged
float32 weights at ``kv_format`` int8 and int4, for the reference's tiny
``dense`` (GQA) and ``mla`` configs: prompts longer than the prefill
chunk (the resumed path), two prompts sharing a whole-page prefix that is
not page-aligned (prefix sharing plus a copy-on-write page, whose scales
move with it), and more requests than slots.  Tokens, completion order,
counters and TTFT ticks must be equal, and the per-token logits within
``atol=1e-5``.  Then, on the port alone, the reference's engine-level
contracts (``tests/test_quant_pool.py``): int8 logits bit for bit the
same with prefix sharing on and off, and an int8 pool within the logit
budget of the fp pool at a smaller size; and packed w8a8 weights over an
int8 pool against the JAX engine.
"""
import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quant import QuantConfig as JaxQuant
from repro.kernels.ops import PackedWeight as JaxPacked
from repro.models import ArchConfig as JaxCfg
from repro.models import init_params as jax_init_params
from repro.models.model import quantize_for_serving as jax_quantize
from repro.serve import Request as JaxRequest
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import ServingEngine as JaxEngine
from repro_torch.core.quant import QuantConfig
from repro_torch.kernels import paged_flash_decode as pfd
from repro_torch.launch import serve as launcher
from repro_torch.models.config import ArchConfig
from repro_torch.serve import Request, ServeConfig, ServingEngine
from repro_torch.weights import from_jax_numpy

DENSE = dict(name="cb", family="dense", n_layers=2, d_model=64, n_heads=4,
             n_kv_heads=2, d_ff=128, vocab_size=100, decode_margin=32)
MLA = dict(name="srv_mla", family="dense", n_layers=2, d_model=64,
           n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=100,
           kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
           decode_margin=32, pattern=(("scan", "mla_mlp", 2),))
CFGS = {"dense": DENSE, "mla": MLA}
SERVE = dict(max_batch=3, max_prompt=8, max_new_tokens=6, page_size=4,
             max_seq=40, record_logits=True)
COUNTERS = ["n_cow_copies", "n_shared_admissions", "n_preemptions",
            "peak_active", "tick_no"]
BUDGET_INT8 = 0.5               # tests/test_quant_pool.py's int8 budget


def _prompts():
    rng = np.random.RandomState(1)
    base = [int(t) for t in rng.randint(0, 100, 18)]
    other = [[int(t) for t in rng.randint(0, 100, n)]
             for n in (5, 3, 11, 19, 2, 14)]
    # the sharer (base + [9]) arrives once a short request has freed a
    # slot, while base + [7, 8] is resident and prefilled
    return [base + [7, 8], other[4], other[1], base + [9], other[0],
            other[2], other[3], other[5]]


def _launches():
    return (pfd.launches, pfd.quant_launches, pfd.mla_launches,
            pfd.mla_quant_launches)


@pytest.fixture(scope="module", params=[(c, f) for c in CFGS
                                        for f in ("int8", "int4")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def engines(request):
    name, fmt = request.param
    jc = JaxCfg(**CFGS[name], dtype=jnp.float32)
    tc = ArchConfig(**CFGS[name], dtype=torch.float32)
    jp = jax_init_params(jc, jax.random.PRNGKey(0))
    tp = from_jax_numpy(tc, jax.tree.map(np.asarray, jp), device="cpu")
    prompts = _prompts()
    je = JaxEngine(jc, jp, JaxServeConfig(**SERVE, kv_format=fmt))
    jout = je.run([JaxRequest(i, p) for i, p in enumerate(prompts)])
    before = _launches()
    te = ServingEngine(tc, tp, ServeConfig(**SERVE, kv_format=fmt),
                       device="cpu")
    handles = [te.submit(Request(i, p)) for i, p in enumerate(prompts)]
    tdone = te.drain()
    return {"jax": je, "port": te, "prompts": prompts, "handles": handles,
            "fmt": fmt, "jout": {r.rid: r for r in jout},
            "tout": {r.rid: r for r in tdone},
            "launched": _launches() != before}


def test_every_request_completes(engines):
    assert sorted(engines["tout"]) == list(range(len(engines["prompts"])))
    for h in engines["handles"]:
        assert h.status == "done"
        assert len(h.tokens_so_far) == SERVE["max_new_tokens"]


def test_tokens_equal_reference(engines):
    for rid, ref in engines["jout"].items():
        assert engines["tout"][rid].out_tokens == ref.out_tokens, rid


def test_completion_order_equals_reference(engines):
    assert [r.rid for r in engines["jax"].completed] == \
        [r.rid for r in engines["port"].completed]


@pytest.mark.parametrize("counter", COUNTERS)
def test_counters_equal_reference(engines, counter):
    assert getattr(engines["port"], counter) == \
        getattr(engines["jax"], counter)


def test_ttft_ticks_equal_reference(engines):
    for rid, ref in engines["jout"].items():
        assert engines["tout"][rid].ttft_ticks == ref.ttft_ticks, rid


def test_logits_match_reference(engines):
    for rid, ref in engines["jout"].items():
        got = engines["tout"][rid].logits
        assert len(got) == len(ref.logits) == SERVE["max_new_tokens"]
        for a, b in zip(got, ref.logits):
            np.testing.assert_allclose(a, np.asarray(b), atol=1e-5, rtol=0)


def test_quantized_pool_and_paths_exercised(engines):
    eng = engines["port"]
    assert max(len(p) for p in engines["prompts"]) > SERVE["max_prompt"]
    assert eng.n_shared_admissions >= 1 and eng.n_cow_copies >= 1
    assert eng.pages_in_use() == 0              # every page came back
    leaves = eng.cache[0]
    assert {k for k in leaves if k.endswith("_scale")} and \
        all(v.dtype == (torch.float32 if k.endswith("_scale")
                        else torch.int8) for k, v in leaves.items())
    # the reference's pool has the same leaves, shapes and dtypes
    jleaves = engines["jax"].cache[0]
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in leaves.items()} == \
        {k: (v.shape, v.dtype.name) for k, v in jleaves.items()}
    # CPU: the plain versions ran, no kernel was launched
    assert eng.stats()["kernel_launches"] == 0 and not engines["launched"]


def _serve_logits(cfg, plan, **sc_kw):
    """Serve ``plan`` [(tick, rid, prompt)] on the port; returns tokens,
    per-token logits and the engine."""
    tc = ArchConfig(**cfg, dtype=torch.float32)
    jc = JaxCfg(**cfg, dtype=jnp.float32)
    params = from_jax_numpy(tc, jax.tree.map(
        np.asarray, jax_init_params(jc, jax.random.PRNGKey(0))), device="cpu")
    eng = ServingEngine(tc, params, ServeConfig(record_logits=True, **sc_kw),
                        device="cpu")
    todo = sorted(plan)
    while todo or eng.sched.has_work():
        while todo and todo[0][0] <= eng.tick_no:
            _, rid, p = todo.pop(0)
            eng.submit(Request(rid, list(p)))
        eng.tick()
    toks = {r.rid: r.out_tokens for r in eng.completed}
    lgts = {r.rid: np.stack(r.logits) for r in eng.completed if r.logits}
    return toks, lgts, eng


@pytest.mark.parametrize("cfg", [DENSE, MLA], ids=list(CFGS))
def test_int8_logits_invariant_to_prefix_sharing_and_cow(cfg):
    """Prefix sharing and copy-on-write only re-address stored bytes, and
    the scale leaves ride the page copies: int8 logits are bit for bit
    the same with sharing on and off."""
    shared = [5, 7, 11, 2, 9, 4, 8]
    plan = [(0, 0, shared + [3, 6, 2]), (3, 1, shared + [1, 1, 7])]
    kw = dict(max_batch=2, max_prompt=16, max_new_tokens=6, page_size=4,
              num_pages=16, kv_format="int8")
    t_on, l_on, e_on = _serve_logits(cfg, plan, prefix_sharing=True, **kw)
    t_off, l_off, _ = _serve_logits(cfg, plan, prefix_sharing=False, **kw)
    assert e_on.n_shared_admissions > 0 and e_on.n_cow_copies > 0
    assert t_on == t_off
    for rid in l_on:
        np.testing.assert_array_equal(l_on[rid], l_off[rid])


@pytest.mark.parametrize("cfg", [DENSE, MLA], ids=list(CFGS))
def test_engine_quantized_logits_within_budget(cfg):
    """Same plan, fp against int8 pool: the pool is released, its bytes
    are fewer, and every request's first token (same prompt history)
    has logits within the budget."""
    prompts = [[5, 7, 11], [3, 1, 4, 1, 5, 9, 2, 6], [2, 7]]
    plan = [(0, i, p) for i, p in enumerate(prompts)]
    kw = dict(max_batch=2, max_prompt=16, max_new_tokens=5, page_size=4)
    _, l_fp, e_fp = _serve_logits(cfg, plan, kv_format="fp", **kw)
    t_q, l_q, e_q = _serve_logits(cfg, plan, kv_format="int8", **kw)
    assert e_q.pages_in_use() == 0
    assert e_q.pool_bytes_per_shard() < e_fp.pool_bytes_per_shard()
    assert all(len(t_q[r]) == 5 for r in t_q)
    for rid in l_fp:
        err = float(np.max(np.abs(l_fp[rid][0] - l_q[rid][0])))
        assert err < BUDGET_INT8, (rid, err)


def test_pool_bytes_per_shard_count_every_leaf():
    """The byte accounting at the tiny float32 config: fp pools of
    float32, int8/int4 pools of int8 plus 4-byte row scales."""
    tc = ArchConfig(**DENSE, dtype=torch.float32)
    params = from_jax_numpy(tc, jax.tree.map(np.asarray, jax_init_params(
        JaxCfg(**DENSE, dtype=jnp.float32), jax.random.PRNGKey(0))),
        device="cpu")
    rows = 2 * 30 * 4                           # layers x pages x page rows
    kv_row = tc.n_kv_heads * tc.head_dim        # 2 x 16
    want = {"fp": rows * 2 * kv_row * 4, "int8": rows * 2 * (kv_row + 4),
            "int4": rows * 2 * (kv_row // 2 + 4)}
    for fmt, n in want.items():
        eng = ServingEngine(tc, params, ServeConfig(
            max_batch=3, max_prompt=8, max_new_tokens=6, page_size=4,
            max_seq=40, kv_format=fmt), device="cpu")
        assert eng.num_pages == 30 and eng.pool_bytes_per_shard() == n


def _packed_numpy(tree):
    def leaf(x):
        if isinstance(x, JaxPacked):
            return {"packed": np.asarray(x.packed),
                    "scale": np.asarray(x.scale), "k": x.k, "n": x.n,
                    "w_bits": x.w_bits}
        return np.asarray(x)
    return jax.tree.map(leaf, tree,
                        is_leaf=lambda x: isinstance(x, JaxPacked))


def test_packed_w8a8_weights_over_an_int8_pool_equal_reference():
    jc = JaxCfg(**DENSE, dtype=jnp.float32).with_(
        quant=JaxQuant(mode="int", a_bits=8, w_bits=8, use_kernel=False))
    tc = ArchConfig(**DENSE, dtype=torch.float32).with_(
        quant=QuantConfig(mode="int", a_bits=8, w_bits=8))
    jp, _ = jax_quantize(jc, jax_init_params(jc, jax.random.PRNGKey(0)))
    tp = from_jax_numpy(tc, _packed_numpy(jp), device="cpu")
    prompts = _prompts()
    je = JaxEngine(jc, jp, JaxServeConfig(**SERVE, kv_format="int8"))
    jout = {r.rid: r for r in
            je.run([JaxRequest(i, p) for i, p in enumerate(prompts)])}
    te = ServingEngine(tc, tp, ServeConfig(**SERVE, kv_format="int8"),
                       device="cpu")
    tout = {r.rid: r for r in
            te.run([Request(i, p) for i, p in enumerate(prompts)])}
    assert sorted(tout) == sorted(jout) == list(range(len(prompts)))
    for rid, ref in jout.items():
        assert tout[rid].out_tokens == ref.out_tokens, rid
        assert tout[rid].ttft_ticks == ref.ttft_ticks, rid
    for c in COUNTERS:
        assert getattr(te, c) == getattr(je, c), c


@pytest.mark.parametrize("bits", ["8", "4"])
def test_launcher_twin_serves_a_quantized_pool_on_cpu(bits):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launcher.main(["--arch", "qwen2.5-3b", "--reduce", "--device", "cpu",
                       "--kv-bits", bits, "--requests", "3",
                       "--max-batch", "2", "--max-new-tokens", "4"])
    lines = out.getvalue().splitlines()
    assert lines[0].startswith(f"KV pool pages stored as int{bits} (")
    assert sum(ln.startswith("req ") and "[done" in ln for ln in lines) == 3
