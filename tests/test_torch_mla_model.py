"""The port's MLA model against the JAX reference, on the CPU.

The weights come from ``repro.models.init_params`` and cross the port's
numpy bridge.  Two configs, float32: the ``mla`` family config of the
reference's serving tests, and deepseek-v2-lite reduced by
``reduce_config`` with its dense MLA block in every layer (the port's
``deepseek-v2-lite-dense``; the reference builds it from its own config
with ``with_``).

  * ``apply_mla`` alone, on bridged layer-0 weights and a latent pool
    filled with noise: a fresh chunk, a resumed chunk at an offset, and a
    decode step with an inactive slot, in sequence.  Outputs of valid
    rows within ``atol=1e-5``; pool rows the step writes within 1e-6,
    every other row bitwise unchanged;
  * the model forward through the same three steps: logits at valid
    positions within 1e-5, the pools within 1e-5;
  * the weight bridge round-trips bit-exactly (``kv_norm`` in float32
    included), and the port's own init has the reference's layout.
"""
import dataclasses

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
from repro.models.mla import apply_mla as jax_apply_mla
from repro_torch.configs import get_config, reduce_config
from repro_torch.models.config import ArchConfig
from repro_torch.models.mla import apply_mla
from repro_torch.models.model import forward, init_paged_cache, init_params
from repro_torch.weights import from_jax_numpy, to_jax_numpy

ATOL = 1e-5
MLA = dict(name="srv_mla", family="dense", n_layers=2, d_model=64,
           n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=100,
           kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
           decode_margin=32, pattern=(("scan", "mla_mlp", 2),))


def _jax_dsv2l_dense():
    return jax_get_config("deepseek-v2-lite-16b").with_(
        family="dense", pattern=(("scan", "mla_mlp", 27),))


def _configs(name, f32=True):
    """(jax config, port config) pair."""
    if name == "mla":
        return (JaxCfg(**MLA, dtype=jnp.float32),
                ArchConfig(**MLA, dtype=torch.float32))
    jc = jax_reduce(_jax_dsv2l_dense())
    tc = reduce_config(get_config("deepseek-v2-lite-dense"))
    if f32:
        jc, tc = jc.with_(dtype=jnp.float32), tc.with_(dtype=torch.float32)
    return jc, tc


def _numpy_tree(jc, seed=0):
    return jax.tree.map(np.asarray, jax_init_params(jc,
                                                    jax.random.PRNGKey(seed)))


def test_dense_variant_is_the_reference_config_with_its_dense_block():
    want = dataclasses.asdict(_jax_dsv2l_dense())
    got = dataclasses.asdict(get_config("deepseek-v2-lite-dense"))
    for k in ("name", "dtype", "quant"):
        got.pop(k)
    # every field the port's config has (the reference adds TPU knobs)
    assert got == {k: want[k] for k in got}
    assert get_config("deepseek-v2-lite-dense").n_blocks() == 27


# -- apply_mla alone ----------------------------------------------------------

B, S, NP, PS, P = 3, 8, 16, 4, 6


def _steps(tc, rng):
    """Three (mode, x, pos, offset, valid rows, written rows) steps:
    fresh chunk, resumed chunk at an offset, decode with slot 1
    inactive.  ``written`` lists (slot, logical row) pairs."""
    lens1 = np.array([8, 5, 0], np.int32)            # slot 2 sits out
    lens2 = np.array([6, 8, 3], np.int32)
    pos = (lens1 + lens2).astype(np.int32)
    pos[1] = -1
    x = lambda s: rng.randn(B, s, tc.d_model).astype(np.float32)  # noqa
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


def _run_apply_mla(name):
    jc, tc = _configs(name)
    tree = _numpy_tree(jc, seed=3)
    tp = from_jax_numpy(tc, tree, device="cpu").blocks[0].attn
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]), tree["stages"][0]["attn"])
    rng = np.random.RandomState(4)
    width = tc.kv_lora_rank + tc.qk_rope_dim
    noise = rng.randn(NP, PS, width).astype(np.float32)
    tbl = np.full((B, P), -1, np.int32)
    perm = rng.permutation(NP)
    for i in range(B):
        tbl[i, :5] = perm[5 * i:5 * i + 5]
    jpool, tpool = jnp.asarray(noise), torch.from_numpy(noise.copy())
    out = {}
    for step, (mode, x, pos, off, valid, written) in _steps(tc, rng).items():
        before = (np.asarray(jpool).copy(), tpool.numpy().copy())
        jy, jcache = jax_apply_mla(
            jp, jnp.asarray(x), jc, cache={"ckv": jpool}, mode=mode,
            pos=jnp.asarray(pos), pages=jnp.asarray(tbl),
            offset=None if off is None else jnp.asarray(off))
        jpool = jcache["ckv"]
        with torch.inference_mode():
            ty, tcache = apply_mla(
                tp, torch.from_numpy(x), tc, cache={"ckv": tpool},
                mode=mode, pos=torch.from_numpy(pos),
                pages=torch.from_numpy(tbl),
                offset=None if off is None else torch.from_numpy(off))
        assert tcache["ckv"] is tpool                # written in place
        rows = np.zeros((NP, PS), bool)
        for b, t in written:
            rows[tbl[b, t // PS], t % PS] = True
        out[step] = (np.asarray(jy)[valid], ty.numpy()[valid],
                     np.asarray(jpool), tpool.numpy().copy(), before, rows)
    return out


@pytest.fixture(scope="module", params=["mla", "deepseek-v2-lite-dense"])
def mla_steps(request):
    return _run_apply_mla(request.param)


@pytest.mark.parametrize("step", ["fresh", "resume", "decode"])
def test_apply_mla_outputs_match_reference(mla_steps, step):
    want, got = mla_steps[step][:2]
    assert want.size > 0
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("step", ["fresh", "resume", "decode"])
def test_apply_mla_pool_writes_match_reference(mla_steps, step):
    _, _, want, got, before, rows = mla_steps[step]
    assert rows.any()
    np.testing.assert_allclose(got[rows], want[rows], atol=1e-6, rtol=0)
    # every row the step does not write keeps its bytes, in both packages
    np.testing.assert_array_equal(want[~rows], before[0][~rows])
    np.testing.assert_array_equal(got[~rows], before[1][~rows])


# -- the model forward --------------------------------------------------------

def _run_forward(name):
    jc, tc = _configs(name)
    tree = _numpy_tree(jc, seed=1)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = from_jax_numpy(tc, tree, device="cpu")
    rng = np.random.RandomState(2)
    tbl = np.full((B, P), -1, np.int32)
    perm = rng.permutation(NP)
    for i in range(B):
        tbl[i, :5] = perm[5 * i:5 * i + 5]
    jcache = jax_init_cache(jc, B, NP, PS)
    tcache = init_paged_cache(tc, NP, PS, device="cpu")
    assert [{k: v.shape for k, v in s.items()} for s in jcache] == \
        [{k: tuple(v.shape) for k, v in s.items()} for s in tcache]
    out = {}
    for step, (mode, _, pos, off, valid, _) in _steps(tc, rng).items():
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
                     np.asarray(jcache[0]["ckv"]),
                     tcache[0]["ckv"].numpy().copy())
    return out


@pytest.fixture(scope="module", params=["mla", "deepseek-v2-lite-dense"])
def parity(request):
    return _run_forward(request.param)


@pytest.mark.parametrize("step", ["fresh", "resume", "decode"])
def test_forward_logits_match_reference(parity, step):
    want, got, _, _ = parity[step]
    assert want.size > 0
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert (got.argmax(-1) == want.argmax(-1)).all()


@pytest.mark.parametrize("step", ["fresh", "resume", "decode"])
def test_forward_pool_contents_match_reference(parity, step):
    _, _, want, got = parity[step]
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


# -- weights ------------------------------------------------------------------

@pytest.mark.parametrize("name", ["mla", "deepseek-v2-lite-dense"])
def test_weight_bridge_round_trip_bit_exact(name):
    jc, tc = _configs(name, f32=False)
    tree = _numpy_tree(jc)
    assert tree["stages"][0]["attn"]["kv_norm"].dtype == np.float32
    back = to_jax_numpy(tc, from_jax_numpy(tc, tree, device="cpu"))
    la, ta = jax.tree.flatten(tree)
    lb, tb = jax.tree.flatten(back)
    assert ta == tb
    for a, b in zip(la, lb):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_init_params_matches_reference_layout_and_scale():
    jc, tc = _configs("deepseek-v2-lite-dense", f32=False)
    ref = _numpy_tree(jc)
    mine = to_jax_numpy(tc, init_params(tc, torch.Generator().manual_seed(0),
                                        device="cpu"))
    la, ta = jax.tree.flatten(ref)
    lb, tb = jax.tree.flatten(mine)
    assert ta == tb
    for a, b in zip(la, lb):
        assert a.dtype == b.dtype and a.shape == b.shape
        sa, sb = np.std(a.astype(np.float32)), np.std(b.astype(np.float32))
        assert abs(sa - sb) <= 0.15 * max(sa, 1e-3), (a.shape, sa, sb)
