"""The port's attention and MLA on a contiguous cache against the JAX
reference, on the CPU.

``apply_attention`` and ``apply_mla`` take a contiguous cache when
``pages`` is None: 'prefill' (the whole prompt; the cache becomes its
rows padded with zeros) and a fresh chunk run the flash kernel's plain
version, a resumed chunk and decode the paged kernel's through the cache
viewed as pages and an identity table.  Both packages run layer 0 on
bridged weights and the same noise-filled cache, through 'prefill' and
through a fresh chunk (one slot inactive), a resumed chunk at per-slot
offsets and two decode steps (one slot inactive).  Outputs of the valid
rows and the whole cache after each step must agree within
``atol=1e-5``.  Configs, float32: G 1 (H 4 / KV 4), G 2 (H 4 / KV 2),
qk_norm at G 4 (``tests/torch_dense_cases.py``, norm weights drawn from
a seed) and the ``mla`` family config.  The view's page size (4) and
width (the first 20 of 32 rows) cut each slot into several splits.
An inactive MLA slot decodes to 0 in the port and to a masked mean in
the reference (ROADMAP queue 3); the engine discards both, and so do the
checks here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ArchConfig as JaxCfg
from repro.models import init_params as jax_init_params
from repro.models.attention import apply_attention as jax_apply_attention
from repro.models.mla import apply_mla as jax_apply_mla
from repro_torch.models.attention import apply_attention
from repro_torch.models.common import ContigView
from repro_torch.models.config import ArchConfig
from repro_torch.models.mla import apply_mla
from repro_torch.weights import from_jax_numpy
from torch_dense_cases import configs, numpy_tree

ATOL = 1e-5
BASE = dict(family="dense", n_layers=2, d_model=64, n_heads=4, d_ff=128,
            vocab_size=100, decode_margin=32)
FIELDS = {
    "g1": dict(BASE, name="c_g1", n_kv_heads=4),
    "g2": dict(BASE, name="c_g2", n_kv_heads=2),
    "mla": dict(BASE, name="c_mla", n_kv_heads=4, kv_lora_rank=32,
                qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
                pattern=(("scan", "mla_mlp", 2),)),
}
CFGS = ("g1", "g2", "qkn", "mla")
B, S, CAP = 3, 8, 32
VIEW = ContigView(page_size=4, rows=20)


def _layer(name):
    """(jax config, port config, reference layer-0 attention weights,
    port layer-0 attention leaves)."""
    if name == "qkn":
        jc, tc = configs("g4")
        tree = numpy_tree(jc, seed=3)
    else:
        jc = JaxCfg(**FIELDS[name], dtype=jnp.float32)
        tc = ArchConfig(**FIELDS[name], dtype=torch.float32)
        tree = jax.tree.map(np.asarray,
                            jax_init_params(jc, jax.random.PRNGKey(3)))
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]), tree["stages"][0]["attn"])
    tp = from_jax_numpy(tc, tree, device="cpu").blocks[0].attn
    return jc, tc, jp, tp


def _noise_cache(tc, rng):
    if tc.kv_lora_rank:
        shapes = {"ckv": (B, CAP, tc.kv_lora_rank + tc.qk_rope_dim)}
    else:
        shapes = {k: (B, CAP, tc.n_kv_heads, tc.head_dim) for k in "kv"}
    return {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}


def _plan(d_model, rng):
    """(step, mode, x, pos, offset, valid rows) in order.  'prefill'
    starts over from the noise cache; the rest run in sequence."""
    lens1 = np.array([8, 5, 0], np.int32)          # slot 2 inactive
    lens2 = np.array([6, 8, 3], np.int32)
    pos = (lens1 + lens2).astype(np.int32)
    pos[1] = -1                                    # slot 1 sits out
    x = lambda s: rng.randn(B, s, d_model).astype(np.float32)  # noqa: E731
    ar = np.arange(S)[None]
    every = np.ones((B, S), bool)
    return [("prefill", "prefill", x(S), np.int32(0), None, every),
            ("fresh", "chunk", x(S), lens1, None, ar < lens1[:, None]),
            ("resume", "chunk", x(S), lens2, lens1, ar < lens2[:, None]),
            ("decode", "decode", x(1), pos, None, (pos >= 0)[:, None]),
            ("decode2", "decode", x(1), pos + (pos >= 0), None,
             (pos >= 0)[:, None])]


@pytest.fixture(scope="module", params=CFGS)
def parity(request):
    jc, tc, jp, tp = _layer(request.param)
    japply, tapply = ((jax_apply_mla, apply_mla) if tc.kv_lora_rank
                      else (jax_apply_attention, apply_attention))
    rng = np.random.RandomState(4)
    noise = _noise_cache(tc, rng)
    out = {}
    jcache = tcache = None
    for step, mode, x, pos, off, valid in _plan(tc.d_model, rng):
        if step in ("prefill", "fresh"):           # from the noise cache
            jcache = {k: jnp.asarray(v) for k, v in noise.items()}
            tcache = {k: torch.from_numpy(v.copy()) for k, v in noise.items()}
        jy, jcache = japply(
            jp, jnp.asarray(x), jc, cache=jcache, mode=mode,
            pos=jnp.asarray(pos),
            offset=None if off is None else jnp.asarray(off))
        with torch.inference_mode():
            ty, tcache = tapply(
                tp, torch.from_numpy(x), tc, cache=tcache, mode=mode,
                pos=torch.from_numpy(np.asarray(pos)), view=VIEW,
                offset=None if off is None else torch.from_numpy(off))
        out[step] = (np.asarray(jy)[valid], ty.numpy()[valid],
                     {k: np.asarray(v) for k, v in jcache.items()},
                     {k: v.numpy().copy() for k, v in tcache.items()})
    return out


STEPS = ("prefill", "fresh", "resume", "decode", "decode2")


@pytest.mark.parametrize("step", STEPS)
def test_outputs_match_reference(parity, step):
    want, got, _, _ = parity[step]
    assert want.size > 0
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("step", STEPS)
def test_cache_matches_reference(parity, step):
    _, _, want, got = parity[step]
    assert sorted(want) == sorted(got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=ATOL, rtol=0)


def test_untouched_rows_keep_their_bits():
    """A fresh chunk leaves the inactive slot and every row past a
    slot's length as they were; decode leaves an inactive slot's rows."""
    _, tc, _, tp = _layer("g2")
    rng = np.random.RandomState(6)
    noise = _noise_cache(tc, rng)
    cache = {k: torch.from_numpy(v.copy()) for k, v in noise.items()}
    lens = torch.tensor([5, 0, 8], dtype=torch.int32)
    with torch.inference_mode():
        apply_attention(tp, torch.randn(B, S, tc.d_model), tc, cache=cache,
                        mode="chunk", pos=lens)
        apply_attention(tp, torch.randn(B, 1, tc.d_model), tc, cache=cache,
                        mode="decode", pos=torch.tensor([5, -1, 8],
                                                        dtype=torch.int32),
                        view=VIEW)
    for k in "kv":
        got, was = cache[k].numpy(), noise[k]
        assert np.array_equal(got[1], was[1])          # inactive slot
        assert np.array_equal(got[0, 6:], was[0, 6:])  # past len + 1 row
        assert np.array_equal(got[2, 9:], was[2, 9:])
        assert not np.array_equal(got[0, 5], was[0, 5])  # decode wrote
