"""The port's ``attn_moe`` block and forward against the JAX reference, on
the CPU.

The weights come from ``repro.models.init_params`` and cross the numpy
bridge.  Both packages run, on the ``moe`` family config and on reduced
granite-moe-1b-a400m in float32 (capacity factor 8.0 and 4.0, and a copy
of each at 0.5, where chunks drop assignments): a fresh chunk, a resumed
chunk and a decode step with an inactive slot through one permuted page
table, and 'prefill' on a contiguous cache.  Logits at every valid
position (every position of the decode step too: the inactive slot's
token is routed and takes expert capacity, as the reference's) and the
aux loss must agree within 1e-5.  One ``attn_moe`` block alone is held
the same way in modes 'chunk' and 'decode'.  Also: the bridge
round-trips a MoE tree bit for bit, and every leaf's init std is the
reference's (an expert bank's fan-in skips its expert axis), and a dense
model's aux loss stays a host float.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import forward as jax_forward
from repro.models import init_cache as jax_init_contig
from repro.models import init_paged_cache as jax_init_cache
from repro.models.blocks import BLOCKS as JAX_BLOCKS
from repro.models.common import ParamSpec as JaxSpec
from repro.models.model import param_specs as jax_param_specs
from repro_torch.configs import get_config, reduce_config
from repro_torch.models.common import ParamSpec
from repro_torch.models.model import (forward, init_cache, init_paged_cache,
                                      init_params, param_specs)
from repro_torch.weights import from_jax_numpy, to_jax_numpy
from torch_moe_cases import configs, numpy_tree

ATOL = 1e-5
CASES = ("moe", "granite", "moe-0.5", "granite-0.5")
STEPS = ("fresh", "resume", "decode", "prefill")


def _pair(case):
    name, _, factor = case.partition("-")
    return configs(name, float(factor) if factor else None)


def _run_both(case):
    jc, tc = _pair(case)
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
    pos[1] = -1                                     # slot 1 sits decode out
    tok = lambda s_: rng.randint(0, tc.vocab_size, (b, s_))  # noqa: E731
    steps = {
        "fresh": (tok(s), "chunk", lens1, None,
                  np.arange(s)[None] < lens1[:, None]),
        "resume": (tok(s), "chunk", lens2, lens1,
                   np.arange(s)[None] < lens2[:, None]),
        "decode": (tok(1), "decode", pos, None, np.ones((b, 1), bool)),
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


@pytest.mark.parametrize("step", STEPS)
def test_forward_logits_match_reference(parity, step):
    want, got, _, _ = parity[step]
    assert want.size > 0
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("step", STEPS)
def test_forward_aux_matches_reference(parity, step):
    _, _, want, got = parity[step]
    assert want > 0
    assert abs(got - want) <= ATOL


@pytest.mark.parametrize("mode", ["chunk", "decode"])
@pytest.mark.parametrize("case", ["moe", "granite-0.5"])
def test_attn_moe_block_matches_reference(case, mode):
    """Block 0 alone: the reference's ``BLOCKS["attn_moe"].apply`` and the
    port's module on the same hidden states, cache and page table."""
    jc, tc = _pair(case)
    tree = numpy_tree(jc, seed=5)
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]), tree["stages"][0])
    block = from_jax_numpy(tc, tree, device="cpu").blocks[0]
    rng = np.random.RandomState(6)
    b, s = 3, (8 if mode == "chunk" else 1)
    x = rng.randn(b, s, tc.d_model).astype(np.float32)
    tbl = np.arange(12, dtype=np.int32).reshape(b, 4)
    pos = (np.array([8, 3, 0], np.int32) if mode == "chunk"
           else np.array([5, -1, 2], np.int32))
    jcache = jax.tree.map(lambda a: a[0], jax_init_cache(jc, b, 12, 4)[0])
    tcache = {k: v[0] for k, v in
              init_paged_cache(tc, 12, 4, device="cpu")[0].items()}
    jy, _, jaux = JAX_BLOCKS["attn_moe"].apply(
        jp, jnp.asarray(x), jc, jcache, mode, jnp.asarray(pos),
        jnp.asarray(tbl), None)
    with torch.inference_mode():
        ty, _, taux = block(torch.from_numpy(x), tcache, mode,
                            torch.from_numpy(pos), torch.from_numpy(tbl),
                            None, None)
    valid = (np.arange(s)[None] < pos[:, None]) if mode == "chunk" \
        else np.ones((b, 1), bool)
    np.testing.assert_allclose(ty.numpy()[valid], np.asarray(jy)[valid],
                               atol=ATOL, rtol=0)
    assert abs(float(taux) - float(jaux)) <= ATOL


@pytest.mark.parametrize("f32", [True, False])
@pytest.mark.parametrize("name", ["moe", "granite"])
def test_weight_bridge_round_trip_bit_exact(name, f32):
    jc, tc = configs(name, f32=f32)
    tree = numpy_tree(jc)
    model = from_jax_numpy(tc, tree, device="cpu")
    ffn = model.blocks[1].ffn
    assert tuple(ffn["router"].shape) == (tc.d_model, tc.n_experts)
    assert tuple(ffn["w_down"].shape) == (tc.n_experts, tc.d_ff_expert,
                                          tc.d_model)
    back = to_jax_numpy(tc, model)
    la, ta = jax.tree.flatten(tree)
    lb, tb = jax.tree.flatten(back)
    assert ta == tb
    for a, b in zip(la, lb):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def _leaves(tree, prefix=""):
    if isinstance(tree, (ParamSpec, JaxSpec)):
        return {prefix: tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_leaves(v, f"{prefix}/{k}"))
    return out


@pytest.mark.parametrize("name", ["moe", "granite"])
def test_init_std_equals_reference_fan_in(name):
    """Every leaf's std is the reference's: ``scale``, else
    ``fan_in() ** -0.5`` (an (E, d, f) bank's fan-in is d, not E * d)."""
    jc, tc = configs(name)
    want = _leaves(jax_param_specs(jc))
    got = _leaves(param_specs(tc))
    n = tc.n_layers
    for path, spec in got.items():
        parts = path.split("/")
        if parts[1] == "blocks":      # the reference stacks the layers
            ref = want["/stages/0/" + "/".join(parts[3:])]
            assert ref.shape == (n,) + spec.shape, path
        else:
            ref = want[path]
        std = 1.0 if ref.init == "embed" else (
            ref.scale if ref.scale is not None else ref.fan_in() ** -0.5)
        assert spec.init == ref.init, path
        if spec.init in ("normal", "embed"):
            assert spec.std() == pytest.approx(std, rel=1e-12), path
    bank = param_specs(tc)["blocks"][0]["ffn"]["w_gate"]
    assert bank.std() == pytest.approx(tc.d_model ** -0.5)


def test_dense_forward_aux_is_a_host_float():
    """Without experts the aux sum stays the host float 0.0: a dense
    dispatch launches nothing for it."""
    cfg = reduce_config(get_config("qwen2.5-3b")).with_(dtype=torch.float32)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    cache = init_paged_cache(cfg, 8, 16, device="cpu")
    pages = torch.arange(8, dtype=torch.int32).reshape(2, 4)
    with torch.no_grad():
        logits, _, aux = forward(
            params, torch.zeros(2, 1, dtype=torch.long), cfg, cache=cache,
            mode="decode", pos=torch.full((2,), 3, dtype=torch.int32),
            pages=pages)
    assert type(aux) is float and aux == 0.0
    assert torch.isfinite(logits).all()
