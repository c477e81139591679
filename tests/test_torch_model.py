"""The port's model against the JAX reference, on the CPU.

The weights come from ``repro.models.init_params`` and cross through the
port's numpy bridge (:mod:`repro_torch.weights`).  Both packages then run
a fresh chunk, a resumed chunk and a paged decode step through the same
permuted page table from the same (zero) pools, on the test dense config
and on reduced qwen2.5-3b and stablelm-3b in float32.  Logits at every
valid position and the pools after each step must agree within
``atol=1e-5``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce
from repro.models import ArchConfig as JaxCfg
from repro.models import forward as jax_forward
from repro.models import init_paged_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro_torch.configs import get_config, reduce_config
from repro_torch.models.config import ArchConfig
from repro_torch.models.model import (forward, init_paged_cache, init_params,
                                      param_specs)
from repro_torch.weights import from_jax_numpy, to_jax_numpy

ATOL = 1e-5
DENSE = dict(name="cb", family="dense", n_layers=2, d_model=64, n_heads=4,
             n_kv_heads=2, d_ff=128, vocab_size=100, decode_margin=32)


def _configs(name, f32=True):
    """(jax config, port config) pair."""
    if name == "dense":
        return (JaxCfg(**DENSE, dtype=jnp.float32),
                ArchConfig(**DENSE, dtype=torch.float32))
    jc, tc = jax_reduce(jax_get_config(name)), reduce_config(get_config(name))
    if f32:
        jc, tc = jc.with_(dtype=jnp.float32), tc.with_(dtype=torch.float32)
    return jc, tc


def _numpy_tree(jc, seed=0):
    params = jax_init_params(jc, jax.random.PRNGKey(seed))
    return jax.tree.map(np.asarray, params)


# -- weight bridge ------------------------------------------------------------

@pytest.mark.parametrize("name", ["dense", "qwen2.5-3b", "stablelm-3b"])
def test_weight_bridge_round_trip_bit_exact(name):
    jc, tc = _configs(name, f32=False)      # reduced archs stay bf16
    tree = _numpy_tree(jc)
    back = to_jax_numpy(tc, from_jax_numpy(tc, tree, device="cpu"))
    la, ta = jax.tree.flatten(tree)
    lb, tb = jax.tree.flatten(back)
    assert ta == tb
    for a, b in zip(la, lb):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("name", ["qwen2.5-3b", "stablelm-3b"])
def test_init_params_matches_reference_layout_and_scale(name):
    jc, tc = _configs(name, f32=False)
    ref = _numpy_tree(jc)
    gen = torch.Generator().manual_seed(0)
    mine = to_jax_numpy(tc, init_params(tc, gen, device="cpu"))
    la, ta = jax.tree.flatten(ref)
    lb, tb = jax.tree.flatten(mine)
    assert ta == tb
    for a, b in zip(la, lb):
        assert a.dtype == b.dtype and a.shape == b.shape
        sa, sb = np.std(a.astype(np.float32)), np.std(b.astype(np.float32))
        assert abs(sa - sb) <= 0.15 * max(sa, 1e-3), (a.shape, sa, sb)


def test_paged_cache_keeps_reference_layout():
    jc, tc = _configs("qwen2.5-3b")
    want = jax_init_cache(jc, 2, 7, 4)
    got = init_paged_cache(tc, 7, 4, device="cpu")
    assert [{k: v.shape for k, v in s.items()} for s in want] == \
        [{k: tuple(v.shape) for k, v in s.items()} for s in got]


def test_unported_block_program_raises():
    cfg = ArchConfig(name="m", family="moe", n_layers=2, d_model=32,
                     n_heads=4, n_kv_heads=2, d_ff=0, vocab_size=64,
                     n_experts=4, top_k=2)
    with pytest.raises(ValueError, match="ROADMAP"):
        param_specs(cfg)


# -- forward parity: fresh chunk -> resumed chunk -> paged decode -----------

def _run_both(name):
    jc, tc = _configs(name)
    tree = _numpy_tree(jc, seed=1)
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
    pos[1] = -1                                     # slot 1 sits decode out
    steps = {
        "fresh": (rng.randint(0, tc.vocab_size, (b, s)), "chunk", lens1,
                  None, np.arange(s)[None] < lens1[:, None]),
        "resume": (rng.randint(0, tc.vocab_size, (b, s)), "chunk", lens2,
                   lens1, np.arange(s)[None] < lens2[:, None]),
        "decode": (rng.randint(0, tc.vocab_size, (b, 1)), "decode", pos,
                   None, (pos >= 0)[:, None]),
    }
    out = {}
    for step, (toks, mode, p_, off, valid) in steps.items():
        toks = toks.astype(np.int32)
        jl, jcache, _ = jax_forward(
            jp, jnp.asarray(toks), jc, cache=jcache, mode=mode,
            pos=jnp.asarray(p_), pages=jnp.asarray(tbl),
            offset=None if off is None else jnp.asarray(off))
        with torch.inference_mode():
            tl, tcache, _ = forward(
                tp, torch.from_numpy(toks), tc, cache=tcache, mode=mode,
                pos=torch.from_numpy(p_), pages=torch.from_numpy(tbl),
                offset=None if off is None else torch.from_numpy(off))
        out[step] = (np.asarray(jl)[valid], tl.numpy()[valid],
                     [np.asarray(jcache[0][k]) for k in ("k", "v")],
                     [tcache[0][k].numpy().copy() for k in ("k", "v")])
    return out


@pytest.fixture(scope="module", params=["dense", "qwen2.5-3b", "stablelm-3b"])
def parity(request):
    return _run_both(request.param)


@pytest.mark.parametrize("step", ["fresh", "resume", "decode"])
def test_forward_logits_match_reference(parity, step):
    want, got, _, _ = parity[step]
    assert want.size > 0
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("step", ["fresh", "resume", "decode"])
def test_forward_pool_contents_match_reference(parity, step):
    _, _, want, got = parity[step]
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)
