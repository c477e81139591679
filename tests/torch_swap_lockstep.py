"""Lockstep comparison of the port's serving engine with the JAX engine
under swap preemption, shared by ``tests/test_torch_swap.py``,
``tests/test_torch_swap_pools.py`` and ``tests/test_torch_swap_session.py``.

Both engines serve the same submission plan on the same bridged weights
and are stepped tick by tick (:class:`Lockstep`).  After every tick they
must agree on each request's tokens, per-token logits (``atol=1e-5``),
``failed``, ``preempts``, TTFT ticks and handle status; the completion
order; the counters; the swap queue's bytes; the page tables and
refcounts; the IOTLB fault records; and every parked snapshot's metadata
(``nbytes`` included) and contents, recurrent state rows (``slot_rows``)
included.  Within the port, the pages and state rows a swap-in restores
equal the snapshot bit for bit.  With ``scans`` (models with mamba
blocks) the JAX engine ticks eagerly and the port is fed its bf16-rounded
scan weights (``tests/torch_hybrid_cases.py``), the flips counted in
``Lockstep.flips``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import ArchConfig as JaxCfg
from repro.models import init_params as jax_init_params
from repro.serve import Request as JaxRequest
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import ServingEngine as JaxEngine
from repro_torch.core.pageformat import get_format
from repro_torch.models.config import ArchConfig
from repro_torch.serve import Request, ServeConfig, ServingEngine
from repro_torch.weights import from_jax_numpy

DENSE = dict(name="cb", family="dense", n_layers=2, d_model=64, n_heads=4,
             n_kv_heads=2, d_ff=128, vocab_size=100, decode_margin=32)
MLA = dict(name="pg_mla", family="dense", n_layers=2, d_model=64,
           n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=100,
           kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
           decode_margin=32, pattern=(("scan", "mla_mlp", 2),))
COUNTERS = ("n_preemptions", "n_swap_ins", "n_swap_budget_denials",
            "n_cow_copies", "n_shared_admissions", "peak_active", "tick_no")
SNAPSHOT_META = ("prefill_done", "order", "pos", "last_token", "n_pages",
                 "n_max", "growth_due", "nbytes")
ATOL = 1e-5

_PARAMS = {}


def params(cfg_kw):
    """(JAX params, the port's bridged copy) of a float32 config."""
    name = cfg_kw["name"]
    if name not in _PARAMS:
        jc = JaxCfg(**cfg_kw, dtype=jnp.float32)
        tc = ArchConfig(**cfg_kw, dtype=torch.float32)
        jp = jax_init_params(jc, jax.random.PRNGKey(0))
        tp = from_jax_numpy(tc, jax.tree.map(np.asarray, jp), device="cpu")
        _PARAMS[name] = (jc, jp, tc, tp)
    return _PARAMS[name]


def rolled_restore(eng):
    """The planted fault: ``eng._swap_in`` restores every snapshot's
    pages rolled by one logical page."""
    good = eng._swap_in

    def faulty(slot, sw):
        sw.pool_rows = [t.roll(1, dims=1) for t in sw.pool_rows]
        good(slot, sw)
    eng._swap_in = faulty


def _leaf_names(eng):
    """The pool leaves' names, a snapshot's ``pool_rows`` order (a group
    stage's ``b<j>/<leaf>``): the last part says data or scale."""
    def paths(tree, pre):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in paths(tree[k],
                                                           f"{pre}{k}/")]
        return [pre[:-1]]
    names = [x for i, st in enumerate(eng.cache) for x in paths(st, f"{i}/")]
    return [n for n, pooled in zip(names, eng._pooled) if pooled]


def _dequantized(names, rows, kv_format):
    """Each data leaf of a snapshot through the format's dequantization
    with its ``<name>_scale`` leaf (fp pools: the rows themselves)."""
    rows = dict(zip(names, [torch.from_numpy(np.array(r)) for r in rows],
                    strict=True))
    if kv_format == "fp":
        return rows
    fmt = get_format(kv_format)
    return {n: fmt.dequantize(r, rows[n + "_scale"], torch.float32)
            for n, r in rows.items() if not n.endswith("_scale")}


class Lockstep:
    """One JAX engine and one port engine on the same plan, compared
    after every tick.  ``plan``: (tick, rid, prompt, priority) — a
    request is submitted to both engines once their clock reaches its
    tick.  ``fault``: plant :func:`rolled_restore` in the port engine.
    ``swap_outs`` records each port swap-out as (tick, victim rid,
    prefill_done, whether the victim held a page another slot
    references); ``restores`` counts the port's swap-ins checked bit
    for bit against their snapshots."""

    def __init__(self, cfg_kw, serve_kw, plan, fault=False, scans=False):
        jc, jp, tc, tp = params(cfg_kw)
        self.scans, self.flips = scans, 0
        sc = dict(record_logits=True, **serve_kw)
        self.kv_format = sc.get("kv_format", "fp")
        self.je = JaxEngine(jc, jp, JaxServeConfig(**sc))
        self.te = ServingEngine(tc, tp, ServeConfig(**sc), device="cpu")
        self.plan = sorted(plan)
        self.jreq, self.treq = {}, {}
        self.handles, self.jhandles = {}, {}
        self.swap_outs, self.restores = [], 0
        self._watch()
        if fault:
            rolled_restore(self.te)

    def _watch(self):
        te = self.te
        out, inn = te._swap_out, te._swap_in

        def swap_out(slot):
            meta = te.sched.slots[slot]
            pages = te.alloc.page_table[slot]
            shared = bool((te.alloc.refcount[pages[pages >= 0]] > 1).any())
            self.swap_outs.append((te.tick_no, meta.req.rid,
                                   meta.prefill_done, shared))
            out(slot)

        def swap_in(slot, sw):
            inn(slot, sw)
            phys = torch.from_numpy(
                te.alloc.page_table[slot, :sw.n_pages].astype(np.int64))
            for leaf, rows in zip(te._pool_leaves(), sw.pool_rows):
                assert torch.equal(leaf[:, phys], rows), \
                    f"swap-in of request {sw.req.rid} did not restore its " \
                    "snapshot bit for bit"
            for leaf, rows in zip(te._state_leaves(), sw.slot_rows,
                                  strict=True):
                assert torch.equal(leaf[:, slot], rows), \
                    f"swap-in of request {sw.req.rid} did not restore its " \
                    "state rows bit for bit"
            self.restores += 1
        te._swap_out, te._swap_in = swap_out, swap_in

    def _submit(self):
        while self.plan and self.plan[0][0] <= self.te.tick_no:
            _, rid, prompt, prio = self.plan.pop(0)
            self.jreq[rid] = JaxRequest(rid, list(prompt), priority=prio)
            self.treq[rid] = Request(rid, list(prompt), priority=prio)
            self.jhandles[rid] = self.je.submit(self.jreq[rid])
            self.handles[rid] = self.te.submit(self.treq[rid])

    def busy(self) -> bool:
        return bool(self.plan) or self.je.sched.has_work() \
            or self.te.sched.has_work()

    def tick(self):
        self._submit()
        if not self.scans:
            self.je.tick()
            self.te.tick()
        else:
            from torch_hybrid_cases import (count_flips, port_roundings,
                                            reference_roundings,
                                            reference_scans)
            calls, mine = [], []
            with reference_scans(calls):
                self.je.tick()
            ref = reference_roundings(calls)
            with port_roundings(record=mine, feed=ref):
                self.te.tick()
            self.flips += count_flips(mine, ref)
        self.compare()

    def run(self):
        while self.busy():
            self.tick()
        return self

    def compare(self):
        je, te = self.je, self.te
        for c in COUNTERS:
            assert getattr(te, c) == getattr(je, c), c
        assert [r.rid for r in te.completed] == [r.rid for r in je.completed]
        np.testing.assert_array_equal(te.alloc.page_table,
                                      je.alloc.page_table)
        np.testing.assert_array_equal(te.alloc.refcount, je.alloc.refcount)
        assert self.faults(te) == self.faults(je)
        for rid, j in self.jreq.items():
            t = self.treq[rid]
            for f in ("out_tokens", "failed", "done", "preempts",
                      "ttft_ticks"):
                assert getattr(t, f) == getattr(j, f), (rid, f)
            assert len(t.logits) == len(j.logits), rid
            for a, b in zip(t.logits, j.logits):
                np.testing.assert_allclose(a, np.asarray(b), atol=ATOL,
                                           rtol=0, err_msg=f"rid {rid}")
            assert self.handles[rid].status == self.jhandles[rid].status, \
                rid
        assert te.sched.swap_bytes() == je.sched.swap_bytes()
        assert len(te.sched.swapped) == len(je.sched.swapped)
        names = _leaf_names(te)
        for ts, js in zip(te.sched.swapped, je.sched.swapped):
            assert ts.req.rid == js.req.rid
            for f in SNAPSHOT_META:
                assert getattr(ts, f) == getattr(js, f), (ts.req.rid, f)
            assert len(ts.slot_rows) == len(js.slot_rows)
            for a, b in zip(ts.slot_rows, js.slot_rows):
                assert tuple(a.shape) == tuple(b.shape)
                np.testing.assert_allclose(a.float().numpy(),
                                           np.asarray(b, np.float32),
                                           atol=ATOL, rtol=0,
                                           err_msg="snapshot state rows")
            assert ts.spill_step is None and js.spill_step is None
            assert [tuple(r.shape) for r in ts.pool_rows] == \
                [tuple(r.shape) for r in js.pool_rows]
            got = _dequantized(names, ts.pool_rows, self.kv_format)
            want = _dequantized(names, js.pool_rows, self.kv_format)
            for n in got:
                np.testing.assert_allclose(got[n].numpy(), want[n].numpy(),
                                           atol=ATOL, rtol=0,
                                           err_msg=f"snapshot leaf {n}")

    @staticmethod
    def faults(eng):
        return [(f.kind, f.start, f.length) for f in eng.iotlb.faults]

    def drained(self):
        """Every request terminal, the swap queue empty, every page free."""
        assert not self.te.sched.has_work()
        assert self.te.sched.swap_bytes() == 0
        assert self.te.pages_in_use() == 0
        assert self.je.pages_in_use() == 0


def plan_of(prompts, tick=0, priorities=None):
    priorities = priorities or [0] * len(prompts)
    return [(tick, i, p, pr)
            for i, (p, pr) in enumerate(zip(prompts, priorities))]


# a 3-token request decodes while a 13-token prompt fills in 4-row chunks
MID_PROMPT_PLAN = [(0, 0, [5, 7, 3], 0), (1, 1, list(range(2, 15)), 0)]
MID_PROMPT = dict(max_batch=2, max_prompt=4, max_new_tokens=8, page_size=4,
                  max_seq=24, num_pages=5, reserve_decode_pages=False)

