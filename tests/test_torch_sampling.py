"""Temperature sampling in the port's serving engine, on the CPU.

``ServeConfig.temperature`` > 0 draws each token from softmax(logits / T)
over the padded vocab with one ``torch.Generator`` an engine, seeded from
``ServeConfig.seed``; the reference draws with ``jax.random.categorical``.
The two generators give different bits from one seed, so parity is by
distribution: at T 0.5, 1 and 2, the port's empirical frequencies over
N = 40,000 draws of one fixed row (the engine's ``_sample`` on a batch of
copies of it) lie within total-variation distance ``TV_BOUND`` of the
softmax, and of the reference's ``jax.random.categorical`` frequencies
over as many draws.  (With 40 categories and 40,000 draws, the expected
TV distance of an empirical distribution from its own is at most
0.5 sqrt(2 / (pi N)) sum_i sqrt(p_i) <= 0.013, and of two empirical ones
0.018; the bound is about twice that.)  The same seed gives the same
tokens through
the engine's session; T = 0 stays the float32 argmax.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduce_config
from repro_torch.models.model import init_params
from repro_torch.serve import Request, ServeConfig, ServingEngine

N = 40_000
V = 40
TV_BOUND = 0.035
TEMPS = (0.5, 1.0, 2.0)


def _row():
    """A fixed logits row: a spread of values, two equal maxima."""
    row = np.random.RandomState(0).randn(V).astype(np.float32) * 1.5
    row[7] = row[11] = row.max() + 0.3
    return row


def _freq(tokens):
    return np.bincount(np.asarray(tokens).reshape(-1), minlength=V) / N


def _tv(p, q):
    return 0.5 * float(np.abs(p - q).sum())


@pytest.fixture(scope="module")
def engine():
    cfg = reduce_config(get_config("qwen2.5-3b")).with_(dtype=torch.float32)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    return cfg, params


def _engine(engine, **kw):
    cfg, params = engine
    return ServingEngine(cfg, params, ServeConfig(max_batch=2, max_prompt=8,
                                                  max_new_tokens=6, **kw),
                         device="cpu")


@pytest.mark.parametrize("temp", TEMPS)
def test_frequencies_follow_the_softmax(engine, temp):
    eng = _engine(engine, temperature=temp, seed=3)
    row = _row()
    got = _freq(eng._sample(torch.from_numpy(np.tile(row, (N, 1)))))
    want = torch.softmax(torch.from_numpy(row) / temp, -1).numpy()
    tv = _tv(got, want)
    print(f"T {temp}: TV(port, softmax) {tv:.4f}")
    assert tv <= TV_BOUND


@pytest.mark.parametrize("temp", TEMPS)
def test_frequencies_follow_the_references_draws(engine, temp):
    eng = _engine(engine, temperature=temp, seed=4)
    row = _row()
    got = _freq(eng._sample(torch.from_numpy(np.tile(row, (N, 1)))))
    ref = jax.random.categorical(jax.random.PRNGKey(4),
                                 jnp.tile(jnp.asarray(row), (N, 1)) / temp)
    tv = _tv(got, _freq(ref))
    print(f"T {temp}: TV(port, jax.random.categorical) {tv:.4f}")
    assert tv <= TV_BOUND


def test_the_generator_lives_on_the_engines_device(engine):
    eng = _engine(engine, temperature=1.0, seed=9)
    assert eng.generator.device == eng.device
    assert eng.generator.initial_seed() == 9


def _serve(engine, **kw):
    eng = _engine(engine, **kw)
    prompts = [[5, 7, 11, 2], [3, 1, 4, 1, 5, 9], [2, 7, 1, 8, 2, 8, 1]]
    done = eng.run([Request(i, p) for i, p in enumerate(prompts)])
    return {r.rid: r.out_tokens for r in done}


def test_the_same_seed_gives_the_same_tokens(engine):
    a = _serve(engine, temperature=1.0, seed=11)
    assert a == _serve(engine, temperature=1.0, seed=11)
    assert a != _serve(engine, temperature=1.0, seed=12)
    assert all(len(t) == 6 for t in a.values())


def test_temperature_zero_is_the_argmax(engine):
    eng = _engine(engine, temperature=0.0, seed=1)
    row = torch.from_numpy(np.tile(_row(), (4, 1)))
    assert (eng._sample(row) == 7).all()      # the lower of two maxima
