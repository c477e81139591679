"""The port's attention on quantized KV pools against the JAX reference,
on the CPU, in float32.

  * ``apply_attention`` (GQA) and ``apply_mla`` (the latent pool) alone,
    on bridged layer-0 weights of the reference's tiny ``dense`` and
    ``mla`` configs, through a fresh chunk, a resumed chunk and a decode
    step with an inactive slot, on int8 and int4 pools filled with
    quantized noise: outputs of valid rows within ``atol=1e-5``; the rows
    each step writes hold the reference's integers, their scales within
    a few float32 ulps (the fp rows they quantize come out of the two
    frameworks' matmuls); every other row keeps its bytes;
  * a quantized fresh chunk runs as a resume at offset 0, never through
    the flash kernel, and gives the resume's output bit for bit;
  * the reference's logit budgets (``tests/test_quant_pool.py``): the
    port's quantized forward against its own fp forward, per format.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.pageformat import get_format as jax_format
from repro.models import ArchConfig as JaxCfg
from repro.models import init_params as jax_init_params
from repro.models.attention import apply_attention as jax_apply_attention
from repro.models.mla import apply_mla as jax_apply_mla
from repro_torch.models import attention as tattn
from repro_torch.models import mla as tmla
from repro_torch.models.config import ArchConfig
from repro_torch.models.model import forward, init_paged_cache, init_params
from repro_torch.weights import from_jax_numpy

ATOL = 1e-5
GQA = dict(name="pg", family="dense", n_layers=2, d_model=64, n_heads=4,
           n_kv_heads=2, d_ff=128, vocab_size=100, decode_margin=32)
MLA = dict(name="pg_mla", family="dense", n_layers=2, d_model=64,
           n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=100,
           kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
           decode_margin=32, pattern=(("scan", "mla_mlp", 2),))
CFGS = {"gqa": GQA, "mla": MLA}
# tests/test_quant_pool.py's budgets for the largest |logit error|
BUDGET = {"int8": 0.5, "int4": 2.5}
B, S, NP, PS, P = 3, 8, 16, 4, 6


def _steps(d_model, rng):
    """(mode, x, pos, offset, valid rows, written (slot, row)) of a fresh
    chunk, a resumed chunk at an offset, and a decode step with slot 1
    inactive."""
    lens1 = np.array([8, 5, 0], np.int32)            # slot 2 sits out
    lens2 = np.array([6, 8, 3], np.int32)
    pos = (lens1 + lens2).astype(np.int32)
    pos[1] = -1
    x = lambda s: rng.randn(B, s, d_model).astype(np.float32)  # noqa
    ar = np.arange(S)
    return {
        "fresh": ("chunk", x(S), lens1, None, ar[None] < lens1[:, None],
                  [(b, t) for b in range(B) for t in range(lens1[b])]),
        "resume": ("chunk", x(S), lens2, lens1, ar[None] < lens2[:, None],
                   [(b, lens1[b] + t) for b in range(B)
                    for t in range(lens2[b])]),
        "decode": ("decode", x(1), pos, None, (pos >= 0)[:, None],
                   [(b, pos[b]) for b in range(B) if pos[b] >= 0]),
    }


def _noise_cache(kind, cfg, name, rng):
    """A layer's quantized pool filled with quantized noise (the
    reference's quantizer), as numpy leaves."""
    fmt = jax_format(name)
    if kind == "gqa":
        shape = {"k": (NP, PS, cfg.n_kv_heads, cfg.head_dim)}
        shape["v"] = shape["k"]
    else:
        shape = {"ckv": (NP, PS, cfg.kv_lora_rank + cfg.qk_rope_dim)}
    out = {}
    for leaf, shp in shape.items():
        q, s = fmt.quantize_rows(jnp.asarray(rng.randn(*shp), jnp.float32))
        out[leaf], out[leaf + "_scale"] = np.asarray(q), np.asarray(s)
    return out


def _run_apply(kind, name):
    cfg = CFGS[kind]
    jc = JaxCfg(**cfg, dtype=jnp.float32)
    tc = ArchConfig(**cfg, dtype=torch.float32)
    tree = jax.tree.map(np.asarray, jax_init_params(jc,
                                                    jax.random.PRNGKey(3)))
    tp = from_jax_numpy(tc, tree, device="cpu").blocks[0].attn
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]), tree["stages"][0]["attn"])
    jfn, tfn = ((jax_apply_attention, tattn.apply_attention) if kind == "gqa"
                else (jax_apply_mla, tmla.apply_mla))
    rng = np.random.RandomState(4)
    noise = _noise_cache(kind, tc, name, rng)
    tbl = np.full((B, P), -1, np.int32)
    perm = rng.permutation(NP)
    for i in range(B):
        tbl[i, :5] = perm[5 * i:5 * i + 5]
    jcache = {k: jnp.asarray(v) for k, v in noise.items()}
    tcache = {k: torch.from_numpy(v.copy()) for k, v in noise.items()}
    out = {}
    for step, (mode, x, pos, off, valid, written) in \
            _steps(tc.d_model, rng).items():
        before = {k: v.numpy().copy() for k, v in tcache.items()}
        jy, jcache = jfn(jp, jnp.asarray(x), jc, cache=jcache, mode=mode,
                         pos=jnp.asarray(pos), pages=jnp.asarray(tbl),
                         offset=None if off is None else jnp.asarray(off))
        with torch.inference_mode():
            ty, got = tfn(tp, torch.from_numpy(x), tc, cache=tcache,
                          mode=mode, pos=torch.from_numpy(pos),
                          pages=torch.from_numpy(tbl),
                          offset=None if off is None
                          else torch.from_numpy(off))
        assert all(got[k] is tcache[k] for k in tcache)   # in place
        rows = np.zeros((NP, PS), bool)
        for b, t in written:
            rows[tbl[b, t // PS], t % PS] = True
        out[step] = (np.asarray(jy)[valid], ty.numpy()[valid],
                     {k: np.asarray(v) for k, v in jcache.items()},
                     {k: v.numpy().copy() for k, v in tcache.items()},
                     before, rows)
    return out


@pytest.fixture(scope="module", params=[(k, f) for k in CFGS
                                        for f in ("int8", "int4")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def applied(request):
    return _run_apply(*request.param)


@pytest.mark.parametrize("step", ["fresh", "resume", "decode"])
def test_outputs_on_quantized_pool_match_reference(applied, step):
    want, got = applied[step][:2]
    assert want.size > 0
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("step", ["fresh", "resume", "decode"])
def test_quantized_pool_writes_match_reference(applied, step):
    _, _, want, got, before, rows = applied[step]
    assert rows.any()
    for leaf in want:
        if leaf.endswith("_scale"):
            # float32 row scales of rows that differ by ulps
            np.testing.assert_allclose(got[leaf][rows], want[leaf][rows],
                                       rtol=2e-6, atol=0)
        else:
            np.testing.assert_array_equal(got[leaf][rows], want[leaf][rows])
        # every row the step does not write keeps its bytes
        np.testing.assert_array_equal(got[leaf][~rows], before[leaf][~rows])


@pytest.mark.parametrize("kind", list(CFGS))
def test_quantized_fresh_chunk_runs_as_a_resume_at_offset_zero(kind,
                                                                monkeypatch):
    cfg = ArchConfig(**CFGS[kind], dtype=torch.float32)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu").blocks[0].attn
    fn = tattn.apply_attention if kind == "gqa" else tmla.apply_mla
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(B, S, cfg.d_model).astype(np.float32))
    lens = torch.tensor([8, 5, 0], dtype=torch.int32)
    tbl = torch.arange(B * P, dtype=torch.int32).reshape(B, P) % NP

    def run(offset):
        cache = {k: v[0] for k, v in init_paged_cache(
            cfg, NP, PS, kv_format="int4", device="cpu")[0].items()}
        with torch.inference_mode():
            y, cache = fn(params, x, cfg, cache=cache, mode="chunk",
                          pos=lens, pages=tbl, offset=offset)
        return y, cache

    def no_flash(*a, **k):
        raise AssertionError("a quantized fresh chunk reached the flash "
                             "kernel")
    monkeypatch.setattr(tattn, "flash_attention", no_flash)
    monkeypatch.setattr(tmla, "flash_attention", no_flash)
    fresh, c1 = run(None)
    resumed, c2 = run(torch.zeros(B, dtype=torch.int32))
    assert torch.equal(fresh, resumed)
    assert all(torch.equal(c1[k], c2[k]) for k in c1)


def _forward_logits(cfg, params, kv_format):
    """tests/test_quant_pool.py's forward plan: a chunk, then three
    greedy decode steps; the last-position logits of each."""
    b, sp, ps, n_pages = 2, 8, 32, 16
    rng = np.random.RandomState(1)
    toks = torch.from_numpy(rng.randint(0, cfg.vocab_size, (b, sp))
                            .astype(np.int32))
    lens = torch.tensor([5, 8], dtype=torch.int32)
    pages = torch.tensor([[5, 2, 7, 0, 9, 12, 15, 10],
                          [1, 6, 3, 4, 13, 8, 11, 14]], dtype=torch.int32)
    cache = init_paged_cache(cfg, n_pages, ps, kv_format=kv_format,
                             device="cpu")
    out = []
    with torch.inference_mode():
        lg, cache, _ = forward(params, toks, cfg, cache=cache, mode="chunk",
                               pos=lens, pages=pages)
        out.append(lg[:, -1].numpy())
        pos, tok = lens.clone(), torch.tensor([[3], [7]], dtype=torch.int32)
        for _ in range(3):
            lg, cache, _ = forward(params, tok, cfg, cache=cache,
                                   mode="decode", pos=pos, pages=pages)
            out.append(lg[:, -1].numpy())
            tok = lg[:, -1].argmax(-1)[:, None].to(torch.int32)
            pos = pos + 1
    return np.stack(out)


@pytest.mark.parametrize("kind", list(CFGS))
@pytest.mark.parametrize("name", ["int8", "int4"])
def test_quantized_forward_logits_within_budget(kind, name):
    cfg = CFGS[kind]
    jc = JaxCfg(**cfg, dtype=jnp.float32)
    tc = ArchConfig(**cfg, dtype=torch.float32)
    tree = jax.tree.map(np.asarray, jax_init_params(jc,
                                                    jax.random.PRNGKey(0)))
    params = from_jax_numpy(tc, tree, device="cpu")
    ref = _forward_logits(tc, params, "fp")
    got = _forward_logits(tc, params, name)
    err = float(np.max(np.abs(got - ref)))
    assert 0.0 < err < BUDGET[name], (name, err)
