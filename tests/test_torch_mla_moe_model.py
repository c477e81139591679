"""The port's two-scan forward and its ``mla_moe`` block against the JAX
reference, on the CPU.

The weights come from ``repro.models.init_params`` and cross the numpy
bridge.  Both packages run reduced deepseek-v2-lite-16b (``mla_mlp`` x 1
+ ``mla_moe`` x 2, 8 experts top-2, 2 shared experts) in float32 at
capacity factors 4.0 and 0.5 (where chunks drop assignments), and a GQA
two-scan program (``attn_mlp`` x 1 + ``attn_moe`` x 2): a fresh chunk, a
resumed chunk, a decode step of every slot and one with an inactive slot
through one permuted page table (each stage's pool read from its own
cache entry), and 'prefill' on a contiguous cache.  Logits at every valid
position must agree within 1e-5 and the aux loss, summed over both
stages, within 1e-6.

An inactive decode slot (``pos`` -1) is routed like any token, as the
reference routes it.  On a GQA layer its row is the reference's, so the
whole step is compared.  On an MLA layer the reference's one-device path
softmaxes a wholly masked row into the mean of the slot's gathered
window, where its Pallas decode path (the one the port's kernel
replaces) combines empty partials into zeros, as the port does; so with
an inactive MLA slot the active rows' logits are compared, and the aux
loss, which averages over every token, on the steps where every slot is
live.  Decode cannot drop an assignment at these sizes (capacity 8 a
dispatch of 3 tokens), so the inactive row cannot move an active one.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import forward as jax_forward
from repro.models import init_cache as jax_init_contig
from repro.models import init_paged_cache as jax_init_cache
from repro_torch.models.model import forward, init_cache, init_paged_cache
from repro_torch.weights import from_jax_numpy
from torch_mla_moe_cases import CASES, configs, numpy_tree

ATOL = 1e-5
AUX_ATOL = 1e-6
STEPS = ("fresh", "resume", "decode", "prefill")
LOGIT_STEPS = STEPS + ("decode_inactive",)


def _run_both(case):
    jc, tc = configs(case)
    tree = numpy_tree(jc, seed=1)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = from_jax_numpy(tc, tree, device="cpu")
    b, s, n_pages, ps, p = 3, 8, 16, 4, 6
    rng = np.random.RandomState(2)
    tbl = np.full((b, p), -1, np.int32)
    perm = rng.permutation(n_pages)
    for i in range(b):
        tbl[i, :5] = perm[5 * i:5 * i + 5]
    jcache = jax_init_cache(jc, b, n_pages, ps)
    tcache = init_paged_cache(tc, n_pages, ps, device="cpu")
    lens1 = np.array([8, 5, 0], np.int32)           # slot 2 inactive
    lens2 = np.array([6, 8, 3], np.int32)
    pos = (lens1 + lens2).astype(np.int32)
    pos2 = pos + 1
    pos2[1] = -1                                    # slot 1 sits decode out
    mla = case.startswith("deepseek")
    tok = lambda s_: rng.randint(0, tc.vocab_size, (b, s_))  # noqa: E731
    steps = {
        "fresh": (tok(s), "chunk", lens1, None,
                  np.arange(s)[None] < lens1[:, None]),
        "resume": (tok(s), "chunk", lens2, lens1,
                   np.arange(s)[None] < lens2[:, None]),
        "decode": (tok(1), "decode", pos, None, np.ones((b, 1), bool)),
        "decode_inactive": (tok(1), "decode", pos2, None,
                            (pos2 >= 0)[:, None] if mla
                            else np.ones((b, 1), bool)),
    }
    out = {}
    for step, (toks, mode, p_, off, valid) in steps.items():
        toks = toks.astype(np.int32)
        jl, jcache, jaux = jax_forward(
            jp, jnp.asarray(toks), jc, cache=jcache, mode=mode,
            pos=jnp.asarray(p_), pages=jnp.asarray(tbl),
            offset=None if off is None else jnp.asarray(off))
        with torch.inference_mode():
            tl, tcache, taux = forward(
                tp, torch.from_numpy(toks), tc, cache=tcache, mode=mode,
                pos=torch.from_numpy(p_), pages=torch.from_numpy(tbl),
                offset=None if off is None else torch.from_numpy(off))
        out[step] = (np.asarray(jl)[valid], tl.numpy()[valid], float(jaux),
                     float(taux))
    # each stage's pools, as both forwards left them
    out["pools"] = [{k: (np.asarray(jcache[i][k]), tcache[i][k].numpy())
                     for k in tcache[i]} for i in range(len(tcache))]
    # 'prefill': the whole prompt into a contiguous cache, every slot
    toks = tok(s).astype(np.int32)
    jl, _, jaux = jax_forward(jp, jnp.asarray(toks), jc,
                              cache=jax_init_contig(jc, b, s),
                              mode="prefill")
    with torch.inference_mode():
        tl, _, taux = forward(tp, torch.from_numpy(toks), tc,
                              cache=init_cache(tc, b, s, device="cpu"),
                              mode="prefill")
    out["prefill"] = (np.asarray(jl), tl.numpy(), float(jaux), float(taux))
    return out


@pytest.fixture(scope="module", params=CASES)
def parity(request):
    return _run_both(request.param)


@pytest.mark.parametrize("step", LOGIT_STEPS)
def test_forward_logits_match_reference(parity, step):
    want, got, _, _ = parity[step]
    assert want.size > 0
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("step", STEPS)
def test_forward_aux_matches_reference(parity, step):
    """The aux loss, summed over both stages' MoE blocks."""
    _, _, want, got = parity[step]
    assert want > 0
    assert abs(got - want) <= AUX_ATOL


def test_each_stage_pool_matches_reference(parity):
    """After fresh, resumed and decode writes, each stage's pools equal
    the reference's: the layers of stage 1 never land in stage 0's."""
    assert len(parity["pools"]) == 2
    for stage in parity["pools"]:
        for want, got in stage.values():
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
            assert np.abs(got).max() > 0
