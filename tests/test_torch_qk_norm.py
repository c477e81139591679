"""qk_norm in the port's attention against the JAX reference, on the CPU.

qwen3's attention RMS-norms each head of q and k by float32 weights
(``q_norm``, ``k_norm``, shape (dh,)) after the projections and before
RoPE; the normed, roped k is what goes into the pool.  The weights come
from ``repro.models.init_params``, with ``q_norm`` and ``k_norm`` redrawn
from a seed (the init leaves them at ones, where a swap of the two or the
norm applied after RoPE would change nothing), and cross through the
bridge.  Configs, all float32 (``tests/torch_dense_cases.py``): reduced
qwen3-8b (H 4 / KV 4, G 1) and two built from the same fields in both
packages, G 4 (H 8 / KV 2, dh 16) and G 7 (H 7 / KV 1, d 112, dh 16).

  * ``attn_specs`` declares the reference's two leaves;
  * ``apply_attention`` alone through a fresh chunk, a resumed chunk and a
    decode step (an inactive slot in each), on an fp pool and on an int8
    pool (whose fresh chunk runs as a resume at offset 0): outputs of the
    valid rows and the pool within ``atol=1e-5``;
  * the forward through the same three steps: logits within 1e-5;
  * a planted fault (q_norm and k_norm swapped in the port) lands outside
    the tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.pageformat import get_format as jax_format
from repro.models import forward as jax_forward
from repro.models import init_paged_cache as jax_init_cache
from repro.models.attention import apply_attention as jax_apply_attention
from repro_torch.configs import get_config
from repro_torch.models import attention as tattn
from repro_torch.models.model import forward, init_paged_cache, param_specs
from repro_torch.weights import from_jax_numpy
from torch_dense_cases import configs, numpy_tree

ATOL = 1e-5
CFGS = ("qwen3-8b", "g4", "g7")
B, S, NP, PS, P = 3, 8, 16, 4, 6


def _table(rng):
    tbl = np.full((B, P), -1, np.int32)
    perm = rng.permutation(NP)
    for i in range(B):
        tbl[i, :5] = perm[5 * i:5 * i + 5]
    return tbl


def _steps(d_model, rng):
    """(mode, x, pos, offset, valid rows) of a fresh chunk, a resumed
    chunk and a decode step; one slot sits out of each."""
    lens1 = np.array([8, 5, 0], np.int32)
    lens2 = np.array([6, 8, 3], np.int32)
    pos = (lens1 + lens2).astype(np.int32)
    pos[1] = -1
    x = lambda s: rng.randn(B, s, d_model).astype(np.float32)  # noqa: E731
    ar = np.arange(S)
    return {"fresh": ("chunk", x(S), lens1, None, ar[None] < lens1[:, None]),
            "resume": ("chunk", x(S), lens2, lens1,
                       ar[None] < lens2[:, None]),
            "decode": ("decode", x(1), pos, None, (pos >= 0)[:, None])}


def _pool(cfg, kv_format, rng):
    """A layer's pool filled with noise (quantized by the reference for
    int8), as numpy leaves."""
    shape = (NP, PS, cfg.n_kv_heads, cfg.head_dim)
    out = {}
    for leaf in ("k", "v"):
        noise = rng.randn(*shape).astype(np.float32)
        if kv_format == "fp":
            out[leaf] = noise
            continue
        q, s = jax_format(kv_format).quantize_rows(jnp.asarray(noise))
        out[leaf], out[leaf + "_scale"] = np.asarray(q), np.asarray(s)
    return out


def run_apply(name, kv_format, swap=False):
    """Both packages' ``apply_attention`` on layer 0 through the three
    steps: per step (reference output, port output, reference pool, port
    pool) over the valid rows.  ``swap`` plants the fault in the port:
    q_norm and k_norm exchanged."""
    jc, tc = configs(name)
    tree = numpy_tree(jc, seed=3)
    tp = from_jax_numpy(tc, tree, device="cpu").blocks[0].attn
    if swap:
        with torch.no_grad():
            qn = tp["q_norm"].clone()
            tp["q_norm"].copy_(tp["k_norm"])
            tp["k_norm"].copy_(qn)
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]), tree["stages"][0]["attn"])
    rng = np.random.RandomState(4)
    pool = _pool(tc, kv_format, rng)
    tbl = _table(rng)
    jcache = {k: jnp.asarray(v) for k, v in pool.items()}
    tcache = {k: torch.from_numpy(v.copy()) for k, v in pool.items()}
    out = {}
    for step, (mode, x, pos, off, valid) in _steps(tc.d_model, rng).items():
        jy, jcache = jax_apply_attention(
            jp, jnp.asarray(x), jc, cache=jcache, mode=mode,
            pos=jnp.asarray(pos), pages=jnp.asarray(tbl),
            offset=None if off is None else jnp.asarray(off))
        with torch.inference_mode():
            ty, tcache = tattn.apply_attention(
                tp, torch.from_numpy(x), tc, cache=tcache, mode=mode,
                pos=torch.from_numpy(pos), pages=torch.from_numpy(tbl),
                offset=None if off is None else torch.from_numpy(off))
        out[step] = (np.asarray(jy)[valid], ty.numpy()[valid],
                     {k: np.asarray(v) for k, v in jcache.items()},
                     {k: v.numpy().copy() for k, v in tcache.items()})
    return out


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attn_specs_declare_the_reference_norm_leaves(dtype):
    cfg = get_config("qwen3-8b").with_(dtype=dtype)
    specs = param_specs(cfg)["blocks"][0]["attn"]
    for k in ("q_norm", "k_norm"):
        assert specs[k].shape == (cfg.head_dim,)
        assert specs[k].init == "ones" and specs[k].dtype == torch.float32
    assert "q_norm" not in param_specs(get_config("yi-34b"))["blocks"][0][
        "attn"]


@pytest.fixture(scope="module", params=[(n, f) for n in CFGS
                                        for f in ("fp", "int8")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def applied(request):
    return run_apply(*request.param)


@pytest.mark.parametrize("step", ["fresh", "resume", "decode"])
def test_apply_attention_outputs_match_reference(applied, step):
    want, got = applied[step][:2]
    assert want.size > 0
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("step", ["fresh", "resume", "decode"])
def test_apply_attention_pool_matches_reference(applied, step):
    """The normed, roped k (and v) each step writes, and every other row
    unchanged: fp pools within 1e-5, int8 pools' integers equal and
    their row scales within a few float32 ulps."""
    _, _, want, got = applied[step]
    for leaf in want:
        if leaf.endswith("_scale"):
            np.testing.assert_allclose(got[leaf], want[leaf], rtol=2e-6,
                                       atol=0)
        elif want[leaf].dtype == np.int8:
            np.testing.assert_array_equal(got[leaf], want[leaf])
        else:
            np.testing.assert_allclose(got[leaf], want[leaf], atol=ATOL,
                                       rtol=0)


@pytest.mark.parametrize("name", CFGS)
def test_swapped_norms_are_caught(name):
    """The planted fault: q_norm and k_norm exchanged in the port moves
    its outputs well outside the tolerance (RoPE sits between the norm
    and the score, so the swap is not symmetric)."""
    out = run_apply(name, "fp", swap=True)
    worst = max(np.abs(out[s][1] - out[s][0]).max() for s in out)
    assert worst > 100 * ATOL, worst


# -- the forward: fresh chunk -> resumed chunk -> paged decode --------------

def run_forward(name):
    jc, tc = configs(name)
    tree = numpy_tree(jc, seed=1)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = from_jax_numpy(tc, tree, device="cpu")
    rng = np.random.RandomState(2)
    tbl = _table(rng)
    jcache = jax_init_cache(jc, B, NP, PS)
    tcache = init_paged_cache(tc, NP, PS, device="cpu")
    out = {}
    for step, (mode, _, pos, off, valid) in _steps(tc.d_model, rng).items():
        toks = rng.randint(0, tc.vocab_size,
                           (B, 1 if mode == "decode" else S)).astype(np.int32)
        jl, jcache, _ = jax_forward(
            jp, jnp.asarray(toks), jc, cache=jcache, mode=mode,
            pos=jnp.asarray(pos), pages=jnp.asarray(tbl),
            offset=None if off is None else jnp.asarray(off))
        with torch.inference_mode():
            tl, tcache, _ = forward(
                tp, torch.from_numpy(toks), tc, cache=tcache, mode=mode,
                pos=torch.from_numpy(pos), pages=torch.from_numpy(tbl),
                offset=None if off is None else torch.from_numpy(off))
        out[step] = (np.asarray(jl)[valid], tl.numpy()[valid],
                     [np.asarray(jcache[0][k]) for k in ("k", "v")],
                     [tcache[0][k].numpy().copy() for k in ("k", "v")])
    return out


@pytest.fixture(scope="module", params=CFGS)
def forwarded(request):
    return run_forward(request.param)


@pytest.mark.parametrize("step", ["fresh", "resume", "decode"])
def test_forward_logits_match_reference(forwarded, step):
    want, got, _, _ = forwarded[step]
    assert want.size > 0
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("step", ["fresh", "resume", "decode"])
def test_forward_pools_match_reference(forwarded, step):
    _, _, want, got = forwarded[step]
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)


# -- chip_smoke.py's plain forwards learn qk_norm ----------------------------

def _chip_smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module", params=["fp", "int8"])
def smoke_served(request):
    """The port's CPU engine on float32 G 4 qk_norm weights (norms drawn
    from a seed), and chip_smoke's plain forward of that pool format."""
    from repro_torch.core.pageformat import get_format
    from repro_torch.serve import Request, ServeConfig, ServingEngine
    smoke = _chip_smoke()
    jc, tc = configs("g4")
    params = from_jax_numpy(tc, numpy_tree(jc, seed=5), device="cpu")
    sc = ServeConfig(max_batch=3, max_prompt=8, max_new_tokens=6,
                     page_size=4, max_seq=40, record_logits=True,
                     kv_format=request.param)
    rng = np.random.RandomState(6)
    reqs = [Request(i, [int(t) for t in rng.randint(0, tc.vocab_size, n)])
            for i, n in enumerate((19, 5, 12))]
    ServingEngine(tc, params, sc, device="cpu").run(reqs)
    if request.param == "fp":
        plain = lambda seq: smoke.plain_forward(torch, params, tc,  # noqa
                                                seq)
    else:
        plain = smoke.kv_plain(torch, params, tc, get_format("int8"))
    return smoke, params, plain, reqs


def test_chip_smoke_plain_forward_matches_the_engine(smoke_served):
    """The card's reference for phase 13 (``plain_forward``; on an int8
    pool ``kv_plain``) gives the engine's teacher-forced logits."""
    smoke, _, plain, reqs = smoke_served
    with torch.inference_mode():
        for r in reqs:
            seq = r.prompt + r.out_tokens[:-1]
            ref = plain(seq)[len(r.prompt) - 1:].float()
            got = torch.from_numpy(np.stack(r.logits))
            assert smoke.rel_err(got, ref) < 1e-5, r.rid


def test_chip_smoke_qk_fault_lands_outside(smoke_served):
    """``qk_fault_check``: the plain forward with q_norm and k_norm
    exchanged lands outside phase 13's bound on these norms, and the
    weights are exchanged back afterwards."""
    smoke, params, plain, reqs = smoke_served
    before = [(b.attn["q_norm"].clone(), b.attn["k_norm"].clone())
              for b in params.blocks]
    with torch.inference_mode():
        for r in reqs:
            err, over = smoke.qk_fault_check(torch, params, plain, r,
                                             smoke.SERVE_REL_TOL_BF16, "cpu")
            assert over >= smoke.QK_FAULT_MARGIN and err > 0
    for b, (qn, kn) in zip(params.blocks, before):
        assert torch.equal(b.attn["q_norm"], qn)
        assert torch.equal(b.attn["k_norm"], kn)
