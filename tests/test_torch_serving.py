"""The port's serving engine against the JAX engine, on the CPU.

One engine of each package serves the same requests on the same bridged
float32 weights with ``record_logits=True``: prompts longer than the
prefill chunk (the resumed path), two prompts sharing a whole-page prefix
that is not page-aligned (prefix sharing plus a copy-on-write page), and
more requests than slots.  Tokens must be equal, per-token logits within
``atol=1e-5``, and the engines' counters and TTFT ticks equal.  The same
requests are then served with packed weights (w4a16 on the weight-only
kernel's plain version, w8a8 on the integer one's): the reference's
``quantize_for_serving`` tree crosses the bridge, and tokens, counters
and TTFT ticks must again be equal.
"""
import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ArchConfig as JaxCfg
from repro.core.quant import QuantConfig as JaxQuant
from repro.kernels.ops import PackedWeight as JaxPacked
from repro.models import init_params as jax_init_params
from repro.models.model import quantize_for_serving as jax_quantize
from repro.serve import Request as JaxRequest
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import ServingEngine as JaxEngine
from repro_torch.core.quant import QuantConfig
from repro_torch.kernels import mpq_matmul
from repro_torch.launch import serve as launcher
from repro_torch.models.config import ArchConfig
from repro_torch.serve import Request, ServeConfig, ServingEngine
from repro_torch.weights import from_jax_numpy

DENSE = dict(name="cb", family="dense", n_layers=2, d_model=64, n_heads=4,
             n_kv_heads=2, d_ff=128, vocab_size=100, decode_margin=32)
SERVE = dict(max_batch=3, max_prompt=8, max_new_tokens=6, page_size=4,
             max_seq=40, record_logits=True)
COUNTERS = ["n_cow_copies", "n_shared_admissions", "n_preemptions",
            "peak_active", "tick_no"]


def _prompts():
    rng = np.random.RandomState(1)
    base = [int(t) for t in rng.randint(0, 100, 18)]
    other = [[int(t) for t in rng.randint(0, 100, n)]
             for n in (5, 3, 11, 19, 2, 14)]
    # slot order: the sharer (base + [9]) arrives once a short request
    # has freed a slot, while base + [7, 8] is resident and prefilled
    return [base + [7, 8], other[4], other[1], base + [9], other[0],
            other[2], other[3], other[5]]


@pytest.fixture(scope="module")
def engines():
    jc = JaxCfg(**DENSE, dtype=jnp.float32)
    tc = ArchConfig(**DENSE, dtype=torch.float32)
    jp = jax_init_params(jc, jax.random.PRNGKey(0))
    tp = from_jax_numpy(tc, jax.tree.map(np.asarray, jp), device="cpu")
    prompts = _prompts()
    je = JaxEngine(jc, jp, JaxServeConfig(**SERVE))
    jout = je.run([JaxRequest(i, p) for i, p in enumerate(prompts)])
    te = ServingEngine(tc, tp, ServeConfig(**SERVE), device="cpu")
    handles = [te.submit(Request(i, p)) for i, p in enumerate(prompts)]
    tdone = te.drain()
    return {"jax": je, "port": te, "prompts": prompts,
            "jout": {r.rid: r for r in jout},
            "tout": {r.rid: r for r in tdone}, "handles": handles}


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


def test_logits_match_reference(engines):
    for rid, ref in engines["jout"].items():
        got = engines["tout"][rid].logits
        assert len(got) == len(ref.logits)
        for a, b in zip(got, ref.logits):
            np.testing.assert_allclose(a, np.asarray(b), atol=1e-5, rtol=0)


@pytest.mark.parametrize("counter", COUNTERS)
def test_counters_equal_reference(engines, counter):
    assert getattr(engines["port"], counter) == \
        getattr(engines["jax"], counter)


def test_ttft_ticks_equal_reference(engines):
    for rid, ref in engines["jout"].items():
        assert engines["tout"][rid].ttft_ticks == ref.ttft_ticks, rid


def test_resumed_sharing_and_cow_paths_exercised(engines):
    eng = engines["port"]
    assert max(len(p) for p in engines["prompts"]) > SERVE["max_prompt"]
    assert eng.n_shared_admissions >= 1 and eng.n_cow_copies >= 1
    assert eng.pages_in_use() == 0              # every page came back
    assert eng.stats()["kernel_launches"] == 0  # CPU: plain versions only


def test_submit_after_drain_raises(engines):
    with pytest.raises(RuntimeError, match="closed"):
        engines["port"].submit(Request(99, [1, 2, 3]))


def test_launcher_twin_runs_on_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launcher.main(["--arch", "stablelm-3b", "--reduce", "--device", "cpu",
                       "--requests", "3", "--max-batch", "2",
                       "--max-new-tokens", "4"])
    lines = out.getvalue().splitlines()
    assert sum(ln.startswith("req ") and "[done" in ln for ln in lines) == 3
    assert lines[-1].startswith("device cpu:")


@pytest.mark.parametrize("deadline", [None, 1, 30])
def test_launcher_ttft_deadline_flag(deadline):
    """``--ttft-deadline`` stamps its deadline on the high-priority (odd)
    requests, 8 ticks when it is not given, as the reference's launcher;
    the ledger counts each of them once."""
    out = io.StringIO()
    argv = ["--arch", "qwen3-8b", "--reduce", "--device", "cpu",
            "--requests", "4", "--max-batch", "1", "--max-new-tokens", "3"]
    if deadline is not None:
        argv += ["--ttft-deadline", str(deadline)]
    with contextlib.redirect_stdout(out):
        launcher.main(argv)
    lines = out.getvalue().splitlines()
    want = 8 if deadline is None else deadline
    stamped = [ln for ln in lines if ln.startswith("req ") and "ttft=" in ln]
    assert [ln.split()[1] for ln in stamped] == ["1:", "3:"]
    assert all(f"t/{want}t " in ln for ln in stamped)
    hits = sum(ln.endswith("hit]") for ln in stamped)
    ledger = next(ln for ln in lines if ln.startswith("deadline ledger:"))
    assert ledger == f"deadline ledger: {hits} hit / {2 - hits} miss"
    if deadline == 1:
        assert hits < 2          # one slot: a deadline of one tick is missed
    if deadline == 30:
        assert hits == 2


# -- packed weights -----------------------------------------------------------

QUANTS = {"w4a16": ("wo", 8, 4), "w8a8": ("int", 8, 8)}


def _packed_numpy(tree):
    def leaf(x):
        if isinstance(x, JaxPacked):
            return {"packed": np.asarray(x.packed),
                    "scale": np.asarray(x.scale), "k": x.k, "n": x.n,
                    "w_bits": x.w_bits}
        return np.asarray(x)
    return jax.tree.map(leaf, tree,
                        is_leaf=lambda x: isinstance(x, JaxPacked))


@pytest.fixture(scope="module", params=sorted(QUANTS))
def qengines(request):
    mode, a, w = QUANTS[request.param]
    jc = JaxCfg(**DENSE, dtype=jnp.float32).with_(
        quant=JaxQuant(mode=mode, a_bits=a, w_bits=w, use_kernel=False))
    tc = ArchConfig(**DENSE, dtype=torch.float32).with_(
        quant=QuantConfig(mode=mode, a_bits=a, w_bits=w))
    jp, _ = jax_quantize(jc, jax_init_params(jc, jax.random.PRNGKey(0)))
    tp = from_jax_numpy(tc, _packed_numpy(jp), device="cpu")
    prompts = _prompts()
    je = JaxEngine(jc, jp, JaxServeConfig(**SERVE))
    jout = je.run([JaxRequest(i, p) for i, p in enumerate(prompts)])
    te = ServingEngine(tc, tp, ServeConfig(**SERVE), device="cpu")
    tout = te.run([Request(i, p) for i, p in enumerate(prompts)])
    return {"jax": je, "port": te, "jout": {r.rid: r for r in jout},
            "tout": {r.rid: r for r in tout}}


def test_packed_tokens_equal_reference(qengines):
    assert len(qengines["tout"]) == len(_prompts())
    for rid, ref in qengines["jout"].items():
        got = qengines["tout"][rid]
        assert got.done and not got.failed
        assert got.out_tokens == ref.out_tokens, rid


@pytest.mark.parametrize("counter", COUNTERS)
def test_packed_counters_equal_reference(qengines, counter):
    assert getattr(qengines["port"], counter) == \
        getattr(qengines["jax"], counter)


def test_packed_ttft_ticks_equal_reference(qengines):
    for rid, ref in qengines["jout"].items():
        assert qengines["tout"][rid].ttft_ticks == ref.ttft_ticks, rid


def test_packed_logits_match_reference(qengines):
    for rid, ref in qengines["jout"].items():
        for a, b in zip(qengines["tout"][rid].logits, ref.logits):
            np.testing.assert_allclose(a, np.asarray(b), atol=1e-5, rtol=0)


def test_launcher_twin_serves_packed_weights_on_cpu():
    out = io.StringIO()
    before = mpq_matmul.launches
    with contextlib.redirect_stdout(out):
        launcher.main(["--arch", "qwen2.5-3b", "--reduce", "--device", "cpu",
                       "--quant", "w4a16", "--requests", "3",
                       "--max-batch", "2", "--max-new-tokens", "4"])
    lines = out.getvalue().splitlines()
    assert lines[0] == "serving with w4a16: packed 8 tensors"
    assert sum(ln.startswith("req ") and "[done" in ln for ln in lines) == 3
    assert mpq_matmul.launches == before      # CPU: plain versions only
