"""The port's hybrid forward (Mamba2 blocks, group stages and the shared
attention block) against the JAX reference, on the CPU.

The weights come from ``repro.models.init_params`` (its constant leaves
drawn from the seed, ``tests/torch_hybrid_cases.py``) and cross the numpy
bridge.  Both packages run reduced zamba2-7b (a group stage of 2 x (2
``mamba`` + 1 ``shared_attn``), then 2 ``mamba``) and the reference's
continuous-batching ``hybrid`` and ``ssm`` family configs in float32: a
fresh chunk (a slot of length 0 among them), a resumed chunk (one slot
starting afresh at offset 0), a decode step of every slot and one with an
inactive slot, through one permuted page table, and 'prefill' on a
contiguous cache.  Logits at every valid position must agree within 1e-5,
and after the paged steps each stage's cache leaves (the shared block's
KV pools, one a repeat, and every mamba block's conv and SSM state)
within 1e-5.  Where the scan's bf16 rounding of a weight flips between
the two packages (``torch_hybrid_cases``), the flips are counted and the
port fed the reference's rounded tensors is held to 1e-5 (and its cache
carried on).  The bridge round trip is bit for bit, with the shared
block held once: one module, run at every ``shared_attn`` position.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import forward as jax_forward
from repro.models import init_cache as jax_init_contig
from repro.models import init_paged_cache as jax_init_cache
from repro_torch.models.blocks import AttnMlpBlock, MambaBlock
from repro_torch.models.model import (flat_leaves, forward, init_cache,
                                      init_paged_cache)
from repro_torch.weights import from_jax_numpy, to_jax_numpy
from torch_hybrid_cases import (CASES, configs, count_flips, numpy_tree,
                                port_roundings, reference_roundings,
                                reference_scans)

ATOL = 1e-5
STEPS = ("fresh", "resume", "decode", "decode_inactive", "prefill")


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
    tcache = init_paged_cache(tc, n_pages, ps, batch=b, device="cpu")
    lens1 = np.array([8, 5, 0], np.int32)           # slot 2 not admitted
    lens2 = np.array([6, 8, 3], np.int32)           # slot 2 starts at 0
    pos = (lens1 + lens2).astype(np.int32)
    pos2 = pos + 1
    pos2[1] = -1                                    # slot 1 sits decode out
    tok = lambda s_: rng.randint(0, tc.vocab_size, (b, s_))  # noqa: E731
    steps = {
        "fresh": (tok(s), "chunk", lens1, None,
                  np.arange(s)[None] < lens1[:, None]),
        "resume": (tok(s), "chunk", lens2, lens1,
                   np.arange(s)[None] < lens2[:, None]),
        "decode": (tok(1), "decode", pos, None, np.ones((b, 1), bool)),
        "decode_inactive": (tok(1), "decode", pos2, None,
                            np.ones((b, 1), bool)),
    }
    out = {}

    def both(toks, jcache, tcache, valid, **kw):
        """The reference's logits and cache, and the port's twice from the
        same cache: with its own bf16 rounding, and fed the reference's
        (whose cache is carried on); with the flips between the two."""
        calls, mine = [], []
        with reference_scans(calls):
            jl, jcache, _ = jax_forward(
                jp, jnp.asarray(toks), jc, cache=jcache,
                **{k: None if v is None else jnp.asarray(v)
                   for k, v in kw.items() if k != "mode"}, mode=kw["mode"])
        ref = reference_roundings(calls)
        targs = {k: None if v is None else torch.from_numpy(v)
                 for k, v in kw.items() if k != "mode"}
        with torch.inference_mode():
            own, _, _ = forward(tp, torch.from_numpy(toks), tc,
                                cache=_clone(tcache), mode=kw["mode"],
                                **targs)
            with port_roundings(record=mine, feed=ref):
                fed, tcache, _ = forward(tp, torch.from_numpy(toks), tc,
                                         cache=tcache, mode=kw["mode"],
                                         **targs)
        return (np.asarray(jl)[valid], own.numpy()[valid],
                fed.numpy()[valid], count_flips(mine, ref)), jcache, tcache

    for step, (toks, mode, p_, off, valid) in steps.items():
        out[step], jcache, tcache = both(
            toks.astype(np.int32), jcache, tcache, valid, mode=mode, pos=p_,
            pages=tbl, offset=off)
    # every cache leaf, in the reference's flattening order
    out["cache"] = (jax.tree.leaves(jcache), flat_leaves(tcache))
    out["prefill"], _, _ = both(
        tok(s).astype(np.int32), jax_init_contig(jc, b, s),
        init_cache(tc, b, s, device="cpu"), np.ones((b, s), bool),
        mode="prefill")
    return out


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone()


@pytest.fixture(scope="module", params=CASES)
def parity(request):
    return _run_both(request.param)


@pytest.mark.parametrize("step", STEPS)
def test_forward_logits_match_reference(parity, step):
    """The port's logits within 1e-5 of the reference's.  A step whose
    scans put a weight on the other bf16 neighbour than the reference's
    (a flip) holds the port fed the reference's rounded tensors to 1e-5;
    its flips and its own distance are printed."""
    want, own, fed, flips = parity[step]
    assert want.size > 0
    if flips:
        print(f"{step}: {flips} bf16 flips in the scans; the port's own "
              f"logits {np.abs(own - want).max():.3g} from the reference's")
    else:
        np.testing.assert_array_equal(own, fed)
    np.testing.assert_allclose(fed, want, atol=ATOL, rtol=0)


def test_each_stage_cache_matches_reference(parity):
    """After fresh, resumed and decode writes, every cache leaf (pools
    and per-slot states, the reference's leaf order) equals the
    reference's within 1e-5, and was written."""
    want, got = parity["cache"]
    assert len(got) == len(want) > 0
    for w, g in zip(want, got):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL, rtol=0)
        assert np.abs(g.numpy()).max() > 0


@pytest.mark.parametrize("case", CASES)
def test_bridge_round_trip_is_bit_exact(case):
    jc, tc = configs(case)
    tree = numpy_tree(jc, seed=3)
    tp = from_jax_numpy(tc, tree, device="cpu")
    back = to_jax_numpy(tc, tp)
    flat_a, def_a = jax.tree.flatten(tree)
    flat_b, def_b = jax.tree.flatten(back)
    assert def_a == def_b
    for a, b in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", ["zamba2", "hybrid"])
def test_the_shared_block_is_one_module(case):
    """The shared attention block is held once (``Transformer.shared``,
    ``tree()['shared']``), the other blocks one a layer; a forward runs
    the one module at every ``shared_attn`` position."""
    jc, tc = configs(case)
    tp = from_jax_numpy(tc, numpy_tree(jc), device="cpu")
    kinds = [k for e in tc.pattern for _ in range(e[2]) for k in (
        [e[1]] if e[0] == "scan" else [k for k, c in e[1]
                                       for _ in range(c)])]
    n_shared = kinds.count("shared_attn")
    assert n_shared == 2
    assert isinstance(tp.shared, AttnMlpBlock)
    assert all(isinstance(b, MambaBlock) for b in tp.blocks)
    assert len(tp.blocks) == len(kinds) - n_shared
    assert sum(isinstance(m, AttnMlpBlock) for m in tp.modules()) == 1
    assert set(tp.tree()["shared"]) == {"ln1", "attn", "ln2", "ffn"}
    calls = []
    tp.shared.register_forward_hook(lambda *a: calls.append(1))
    b = 2
    cache = init_paged_cache(tc, 4, 4, batch=b, device="cpu")
    with torch.inference_mode():
        forward(tp, torch.zeros((b, 4), dtype=torch.int32), tc, cache=cache,
                mode="chunk", pos=torch.tensor([4, 2], dtype=torch.int32),
                pages=torch.tensor([[0, -1], [1, -1]], dtype=torch.int32))
    assert len(calls) == n_shared


def test_zamba2_published_program():
    """The published zamba2-7b: 13 groups of 5 mamba blocks and the
    shared block, then 3 mamba blocks (68 mamba blocks, 81 in all),
    112 SSM heads of 64 and attention heads of 112, as the reference's
    arch file; its paged cache is the shared block's 13 KV pools beside
    68 per-slot states."""
    from repro.configs import get_config as jax_get_config
    from repro_torch.configs import get_config
    from repro_torch.models import ssm
    from repro_torch.models.model import cache_specs, param_specs
    tc, jc = get_config("zamba2-7b"), jax_get_config("zamba2-7b")
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
              "vocab_size", "ssm_state", "ssm_headdim", "ssm_expand",
              "ssm_chunk", "pattern", "sub_quadratic", "head_dim"):
        assert getattr(tc, f) == getattr(jc, f), f
    assert tc.n_blocks() == 81 and tc.head_dim == 112
    assert ssm.ssm_dims(tc) == (7168, 112, 7296)
    specs = param_specs(tc)
    assert len(specs["blocks"]) == 68 and "shared" in specs
    leaves = flat_leaves(cache_specs(tc, 8, 0, num_pages=4, page_size=16))
    pooled = [s for s in leaves if s.pooled]
    assert len(pooled) == 2 and all(s.shape[0] == 13 for s in pooled)
    assert sorted(s.shape[0] for s in leaves if not s.pooled) == \
        [3, 3] + [13] * 10
