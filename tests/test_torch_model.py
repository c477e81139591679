"""The port's model against the JAX reference, on the CPU.

The weights come from ``repro.models.init_params`` and cross through the
port's numpy bridge (:mod:`repro_torch.weights`).  Both packages then run
a fresh chunk, a resumed chunk and a paged decode step through the same
permuted page table from the same (zero) pools, on the test dense config
and on reduced qwen2.5-3b and stablelm-3b in float32.  Logits at every
valid position and the pools after each step must agree within
``atol=1e-5``.

Packed weights: the port's ``quantize_for_serving`` must give the
reference's packed bytes and scales bitwise, the packed tree must cross
the bridge bit-exactly both ways, and the packed forward must match the
reference's (oracle path, ``use_kernel=False``) under w4a16, w2a16, w8a8
and w4a8.
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
from repro.core.quant import QuantConfig as JaxQuant
from repro.kernels.ops import PackedWeight as JaxPacked
from repro.models.model import quantize_for_serving as jax_quantize
from repro_torch.core.quant import QuantConfig
from repro_torch.configs import get_config, reduce_config
from repro_torch.models.config import ArchConfig
from repro_torch.kernels.ops import PackedWeight
from repro_torch.models.model import (forward, init_paged_cache, init_params,
                                      param_specs, quantize_for_serving)
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


# name -> (mode, a_bits, w_bits), as the launchers parse --quant
QUANTS = {"w4a16": ("wo", 8, 4), "w2a16": ("wo", 8, 2),
          "w8a8": ("int", 8, 8), "w4a8": ("int", 8, 4)}


def _quant_pair(fmt):
    mode, a, w = QUANTS[fmt]
    return (JaxQuant(mode=mode, a_bits=a, w_bits=w, use_kernel=False),
            QuantConfig(mode=mode, a_bits=a, w_bits=w))


def _packed_numpy(tree):
    """A numpy copy of a packed JAX tree, each PackedWeight as the
    bridge's packed-leaf dict."""
    def leaf(x):
        if isinstance(x, JaxPacked):
            return {"packed": np.asarray(x.packed),
                    "scale": np.asarray(x.scale), "k": x.k, "n": x.n,
                    "w_bits": x.w_bits}
        return np.asarray(x)
    return jax.tree.map(leaf, tree,
                        is_leaf=lambda x: isinstance(x, JaxPacked))


def _assert_trees_bitwise(want, got):
    la, ta = jax.tree.flatten(want)
    lb, tb = jax.tree.flatten(got)
    assert ta == tb
    for a, b in zip(la, lb):
        if isinstance(a, int):
            assert a == b
            continue
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


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
    """A program of two scans (attn_mlp, then attn_moe) was refused before
    ROADMAP queue 1 item 12b; its specs are now the reference's, stage by
    stage (each layer's block in the port, each stage stacked in the
    reference), and the port builds its blocks in the program's order."""
    from repro.models.model import param_specs as jax_param_specs
    fields = dict(name="m", family="moe", n_layers=2, d_model=32,
                  n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=64,
                  n_experts=4, top_k=2, d_ff_expert=16,
                  pattern=(("scan", "attn_mlp", 1), ("scan", "attn_moe", 1)))
    cfg = ArchConfig(**fields)
    specs = param_specs(cfg)
    want = jax_param_specs(JaxCfg(**fields))
    assert len(specs["blocks"]) == 2 and len(want["stages"]) == 2
    for block, stage in zip(specs["blocks"], want["stages"]):
        flat = jax.tree.leaves(block)
        ref = jax.tree.leaves(stage, is_leaf=lambda s: hasattr(s, "init"))
        assert [(1,) + tuple(s.shape) for s in flat] == \
            [tuple(s.shape) for s in ref]
        assert [s.init for s in flat] == [s.init for s in ref]
    assert set(specs["blocks"][1]["ffn"]) == {"router", "w_gate", "w_up",
                                               "w_down"}
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert [type(b).__name__ for b in params.blocks] == ["AttnMlpBlock",
                                                         "AttnMoeBlock"]


# -- forward parity: fresh chunk -> resumed chunk -> paged decode -----------

def _run_both(name, fmt=None):
    jc, tc = _configs(name)
    tree = _numpy_tree(jc, seed=1)
    if fmt is None:
        jp = jax.tree.map(jnp.asarray, tree)
    else:
        jq, tq = _quant_pair(fmt)
        jc, tc = jc.with_(quant=jq), tc.with_(quant=tq)
        jp, _ = jax_quantize(jc, jax.tree.map(jnp.asarray, tree))
        tree = _packed_numpy(jp)
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


# -- packed weights -----------------------------------------------------------

@pytest.mark.parametrize("fmt", sorted(QUANTS))
@pytest.mark.parametrize("name", ["dense", "qwen2.5-3b"])
def test_quantize_for_serving_bitwise_equals_reference(name, fmt):
    jc, tc = _configs(name, f32=False)      # reduced qwen stays bf16
    jq, tq = _quant_pair(fmt)
    jc, tc = jc.with_(quant=jq), tc.with_(quant=tq)
    tree = _numpy_tree(jc)
    jpacked, jn = jax_quantize(jc, jax.tree.map(jnp.asarray, tree))
    tpacked, tn = quantize_for_serving(
        tc, from_jax_numpy(tc, tree, device="cpu"))
    assert tn == jn == 8          # 7 stacked block weights + lm_head
    n_pw = sum(isinstance(m, PackedWeight) for m in tpacked.modules())
    assert n_pw == 7 * tc.n_layers + 1
    _assert_trees_bitwise(_packed_numpy(jpacked), to_jax_numpy(tc, tpacked))


@pytest.mark.parametrize("fmt", ["w4a16", "w8a8"])
def test_packed_bridge_round_trip_bit_exact(fmt):
    jc, tc = _configs("qwen2.5-3b", f32=False)
    jq, tq = _quant_pair(fmt)
    jc, tc = jc.with_(quant=jq), tc.with_(quant=tq)
    jpacked, _ = jax_quantize(jc, jax.tree.map(jnp.asarray, _numpy_tree(jc)))
    tree = _packed_numpy(jpacked)
    model = from_jax_numpy(tc, tree, device="cpu")
    assert isinstance(model.lm_head, PackedWeight)
    assert isinstance(model.blocks[1].ffn["w_down"], PackedWeight)
    _assert_trees_bitwise(tree, to_jax_numpy(tc, model))


def test_raw_weight_under_a_packed_format_raises():
    jc, tc = _configs("dense")
    tc = tc.with_(quant=QuantConfig(mode="wo", w_bits=4))
    tp = from_jax_numpy(tc, _numpy_tree(jc), device="cpu")
    cache = init_paged_cache(tc, 4, 4, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 16"):
        forward(tp, torch.zeros((1, 4), dtype=torch.int32), tc, cache=cache,
                mode="chunk", pos=torch.tensor([4], dtype=torch.int32),
                pages=torch.zeros((1, 1), dtype=torch.int32))


@pytest.fixture(scope="module", params=[
    f"{n}-{f}" for n in ("dense", "qwen2.5-3b") for f in sorted(QUANTS)])
def qparity(request):
    name, fmt = request.param.rsplit("-", 1)
    return _run_both(name, fmt)


# Integer formats quantize each activation row on the fly, and XLA's jit
# computes the row scale one float32 ulp away from the port (see
# test_torch_mpq_matmul.py), which could move a value across a rounding
# boundary.  On these inputs none moves: every format holds atol=1e-5
# (measured worst case 2.4e-7), and the greedy tokens are exact.
@pytest.mark.parametrize("step", ["fresh", "resume", "decode"])
def test_packed_forward_logits_match_reference(qparity, step):
    want, got, _, _ = qparity[step]
    assert want.size > 0
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert (got.argmax(-1) == want.argmax(-1)).all()


@pytest.mark.parametrize("step", ["fresh", "resume", "decode"])
def test_packed_forward_pool_contents_match_reference(qparity, step):
    _, _, want, got = qparity[step]
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)
