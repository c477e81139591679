"""The port's Mamba2 mixer against the JAX reference's, on the CPU.

``repro_torch.models.ssm.apply_mamba`` and ``repro.models.ssm.apply_mamba``
take the same float32 weights, tokens and cached state, made from a seed
with numpy, in every mode the engines run: a fresh chunk ('chunk' without
an offset), a resumed chunk (a row resumed at offset > 0, a fresh row
and a row of length 0 whose state must stay as it was), decode (an
inactive slot at position -1 keeps its state) and 'prefill'; at chunk
lengths that are a multiple of ``ssm_chunk``, that are not (the scan's
chunk halves until it divides), and shorter than the conv's K - 1.  The
output and both state leaves must agree within 1e-5;
``conv_state_from_chunk`` must agree bit for bit.

The scan rounds its intra-chunk weights and ``x * dt`` to bfloat16, so
an ulp of difference before a rounding can move one weight by a bf16 step
(a flip).  ``test_ssd_bf16_flips_are_counted`` counts the flips between
the port's rounded tensors and the reference's, op for op on the same
inputs, and holds the scan's output within 1e-5 beside that count.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.ssm as ref_ssm
from repro.models import ArchConfig as JaxCfg
from repro_torch.models import ssm
from repro_torch.models.config import ArchConfig
from torch_hybrid_cases import (count_flips, port_roundings,
                                reference_roundings, rounded_inputs)

TOL = 1e-5
# the hybrid family config of the reference's continuous-batching tests:
# d_inner 128, 4 SSM heads of 32, state 16, conv 4 (K - 1 = 3), chunk 4
FIELDS = dict(name="ssm_unit", family="hybrid", n_layers=1, d_model=64,
              n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=100,
              ssm_state=16, ssm_headdim=32, ssm_chunk=4)
B = 3


def _configs(**kw):
    fields = dict(FIELDS, **kw)
    return (JaxCfg(**fields, dtype=jnp.float32),
            ArchConfig(**fields, dtype=torch.float32))


def _inputs(tc, s, seed):
    """Float32 weights with every leaf drawn (biases, A_log, D and the
    norm too, so none is an identity), tokens and a random cached
    state."""
    rng = np.random.RandomState(seed)
    d_inner, h, conv_ch = ssm.ssm_dims(tc)
    d, n = tc.d_model, tc.ssm_state
    f32 = np.float32
    p = {"in_proj": rng.randn(d, 2 * d_inner + 2 * n + h) / np.sqrt(d),
         "conv_w": 0.2 * rng.randn(tc.conv_dim, conv_ch),
         "conv_b": 0.1 * rng.randn(conv_ch),
         "A_log": 0.5 * rng.randn(h),
         "D": 1.0 + 0.1 * rng.randn(h),
         "dt_bias": 0.5 * rng.randn(h),
         "norm": 1.0 + 0.1 * rng.randn(d_inner),
         "out_proj": rng.randn(d_inner, d) / np.sqrt(d_inner)}
    p = {k: v.astype(f32) for k, v in p.items()}
    x = rng.randn(B, s, d).astype(f32)
    cache = {"conv": rng.randn(B, tc.conv_dim - 1, conv_ch).astype(f32),
             "ssm": 0.5 * rng.randn(B, h, tc.ssm_headdim, n).astype(f32)}
    return p, x, cache


def _port(tc, p, x, cache, mode, pos, offset):
    tcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    got, gc = ssm.apply_mamba(
        {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x),
        tc, cache=tcache, mode=mode, pos=torch.tensor(pos, dtype=torch.int32),
        offset=None if offset is None else torch.tensor(offset,
                                                        dtype=torch.int32))
    assert gc is tcache                  # updated in place
    return got.numpy(), gc


def _run_both(jc, tc, p, x, cache, mode, pos, offset=None):
    """The reference's and the port's output and state, and the port's
    bf16 flips in the scan: the rounded tensors it made against the
    reference's rounding of the reference's own scan inputs (read at
    ``_ssd_chunked``).  Returns (want, want cache, got, got cache, flips,
    the port's output and cache when fed the reference's rounded
    tensors)."""
    seen, good = {}, ref_ssm._ssd_chunked

    def spy(*args):
        seen["args"] = args
        return good(*args)
    mp = pytest.MonkeyPatch()
    mp.setattr(ref_ssm, "_ssd_chunked", spy)
    mine = []
    try:
        want, wc = ref_ssm.apply_mamba(
            {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), jc,
            cache={k: jnp.asarray(v) for k, v in cache.items()}, mode=mode,
            pos=jnp.asarray(pos, jnp.int32),
            offset=None if offset is None else jnp.asarray(offset,
                                                           jnp.int32))
        got, gc = _port(tc, p, x, cache, mode, pos, offset)
        flips, fed = 0, None
        if "args" in seen:
            ref = reference_roundings([seen["args"]])
            with port_roundings(record=mine, feed=ref):
                fed = _port(tc, p, x, cache, mode, pos, offset)
            flips = count_flips(mine, ref)
    finally:
        mp.undo()
    return np.asarray(want), wc, got, gc, flips, fed


def _assert_close(want, wc, got, gc, flips=0, fed=None):
    """The port within 1e-5 of the reference, output and state.  Where
    the scan rounded a weight to the other bf16 neighbour (``flips`` >
    0), the port fed the reference's rounded tensors (``fed``) is held to
    1e-5 instead, and the flips and the port's own distance are printed:
    the divergence is the flips' and nothing else's."""
    if flips:
        err = np.abs(got - want).max()
        print(f"bf16 flips in the scan: {flips}; the port's own output "
              f"{err:.3g} from the reference's")
    np.testing.assert_allclose(fed[0] if flips else got, want, atol=TOL,
                               rtol=0)
    # the state never passes through the rounding: 1e-5 in both runs
    for c in [gc] + ([fed[1]] if fed is not None else []):
        for k in ("conv", "ssm"):
            assert c[k].dtype == torch.float32
            np.testing.assert_allclose(c[k].numpy(), np.asarray(wc[k]),
                                       atol=TOL, rtol=0, err_msg=k)
    if fed is not None:
        np.testing.assert_allclose(fed[0], want, atol=TOL, rtol=0)


# (S, lengths): a multiple of the chunk (three chunks), 6 (the chunk
# halves to 2), 2 (shorter than K - 1 = 3), 1
CHUNKS = ((12, (12, 7, 0)), (6, (6, 4, 0)), (2, (2, 1, 0)), (1, (1, 0, 1)))


@pytest.mark.parametrize("s,lengths", CHUNKS)
def test_fresh_chunk_matches_reference(s, lengths):
    jc, tc = _configs()
    p, x, cache = _inputs(tc, s, seed=s)
    want, wc, got, gc, *fl = _run_both(jc, tc, p, x, cache, "chunk",
                                       lengths)
    _assert_close(want, wc, got, gc, *fl)
    # a row of length 0 keeps its state bit for bit
    for b, n in enumerate(lengths):
        if n == 0:
            for k in ("conv", "ssm"):
                np.testing.assert_array_equal(gc[k][b].numpy(), cache[k][b])


@pytest.mark.parametrize("s,lengths", CHUNKS)
def test_resumed_chunk_matches_reference(s, lengths):
    """Row 0 resumes at offset 5 (its cached conv and SSM state carry
    on), row 1 starts afresh (offset 0), row 2 sits at offset 3: with
    length 0 it keeps its state, with a length it resumes."""
    jc, tc = _configs()
    p, x, cache = _inputs(tc, s, seed=10 + s)
    want, wc, got, gc, *fl = _run_both(jc, tc, p, x, cache, "chunk",
                                       lengths, offset=(5, 0, 3))
    _assert_close(want, wc, got, gc, *fl)
    for b, n in enumerate(lengths):
        if n == 0:
            for k in ("conv", "ssm"):
                np.testing.assert_array_equal(gc[k][b].numpy(), cache[k][b])


def test_resumed_chunks_carry_the_state():
    """A prompt in two chunks, the second resumed at offset 5 (of 5 and 7
    steps: scan chunks of 1 and 1, neither a multiple of ssm_chunk), each
    the reference's: the state the first leaves is the one the second
    starts from, on both sides.  (One chunk over all 12 steps differs
    from the two at bf16's step: the intra-chunk weights are rounded,
    the state passed between chunks is not, in the reference too.)"""
    jc, tc = _configs()
    p, x, cache = _inputs(tc, 12, seed=3)
    for lo, hi in ((0, 5), (5, 12)):
        lens = (hi - lo,) * B
        want, wc, got, gc, *fl = _run_both(
            jc, tc, p, x[:, lo:hi].copy(), cache, "chunk", lens,
            offset=(lo,) * B)
        _assert_close(want, wc, got, gc, *fl)
        cache = {k: v.numpy() for k, v in gc.items()}


@pytest.mark.parametrize("pos", [(7, -1, 3), (0, 5, -1)])
def test_decode_matches_reference(pos):
    jc, tc = _configs()
    p, x, cache = _inputs(tc, 1, seed=20 + pos[0])
    want, wc, got, gc, *fl = _run_both(jc, tc, p, x, cache, "decode", pos)
    _assert_close(want, wc, got, gc, *fl)
    for b, q in enumerate(pos):
        if q < 0:                        # the inactive slot keeps its state
            for k in ("conv", "ssm"):
                np.testing.assert_array_equal(gc[k][b].numpy(), cache[k][b])


@pytest.mark.parametrize("s,chunk", [(12, 4), (6, 4), (16, 8)])
def test_prefill_matches_reference(s, chunk):
    jc, tc = _configs(ssm_chunk=chunk)
    p, x, cache = _inputs(tc, s, seed=30 + s)
    want, wc, got, gc, *fl = _run_both(jc, tc, p, x, cache, "prefill", 0)
    _assert_close(want, wc, got, gc, *fl)


@pytest.mark.parametrize("history", [False, True])
@pytest.mark.parametrize("s", [1, 2, 3, 9])
def test_conv_state_from_chunk_is_bitwise(s, history):
    rng = np.random.RandomState(s)
    k, c = 4, 10
    u = rng.randn(B, s, c).astype(np.float32)
    old = rng.randn(B, k - 1, c).astype(np.float32)
    hist = rng.randn(B, k - 1, c).astype(np.float32) if history else None
    lens = np.array([s, max(s - 1, 0), 0], np.int32)
    want = ref_ssm.conv_state_from_chunk(
        jnp.asarray(u), k, jnp.asarray(lens), jnp.asarray(old),
        None if hist is None else jnp.asarray(hist))
    got = ssm.conv_state_from_chunk(
        torch.from_numpy(u), k, torch.from_numpy(lens), torch.from_numpy(old),
        None if hist is None else torch.from_numpy(hist))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("s,chunk", [(6, 4), (12, 4), (13, 16), (48, 16)])
def test_chunk_len_is_the_references(s, chunk):
    want = min(chunk, s)
    while s % want:
        want //= 2
    assert ssm.chunk_len(s, chunk) == want


def test_ssd_bf16_flips_are_counted(monkeypatch):
    """The SSD scan alone over 64 steps in chunks of 8 (B 3, 4 heads),
    where the rounded intra-chunk weights number 6,144: the port's
    bf16-rounded weights and x * dt (read at ``ssm._bf16``) against the
    reference's rounding of the same inputs.  A flip (a weight one bf16
    step apart, from an ulp of difference in the float32 cumsum, exp or
    C.B before the rounding) breaks 1e-5 on the rows it feeds; it is
    counted and printed, never absorbed: the port's scan fed the
    reference's rounded tensors must give the reference's output and
    state within 1e-5, and its own output must lie within the flips'
    reach of it (the sum over flipped j of |dw| |x dt|, plus 1e-5) and
    within 1e-5 on every row no flip feeds."""
    rng = np.random.RandomState(7)
    s, l, h, pdim, n = 64, 8, 4, 32, 16
    xh = rng.randn(B, s, h, pdim).astype(np.float32)
    dt = np.log1p(np.exp(rng.randn(B, s, h))).astype(np.float32)
    a = (dt * -np.exp(0.5 * rng.randn(h))[None, None, :]).astype(np.float32)
    b_in = rng.randn(B, s, n).astype(np.float32)
    c_in = rng.randn(B, s, n).astype(np.float32)
    h0 = rng.randn(B, h, pdim, n).astype(np.float32)
    want_y, want_h = jax.jit(ref_ssm._ssd_chunked, static_argnums=6)(
        *(jnp.asarray(v) for v in (xh, dt, a, b_in, c_in, h0)), l)
    want_y, want_h = np.asarray(want_y), np.asarray(want_h)
    t = [torch.from_numpy(v) for v in (xh, dt, a, b_in, c_in, h0)]
    ref = rounded_inputs(*(jnp.asarray(v) for v in (xh, dt, a, b_in, c_in)),
                         l)
    mine, good = [], ssm._bf16

    def spy(x):
        mine.append(good(x))
        return mine[-1]
    monkeypatch.setattr(ssm, "_bf16", spy)
    got_y, got_h = (v.numpy() for v in ssm._ssd_chunked(*t, l))
    fed = iter(ref)
    monkeypatch.setattr(ssm, "_bf16", lambda x: next(fed))
    sub_y, sub_h = (v.numpy() for v in ssm._ssd_chunked(*t, l))
    w, rw = torch.stack(mine[0::2]).numpy(), torch.stack(ref[0::2]).numpy()
    xdt, rx = torch.stack(mine[1::2]).numpy(), torch.stack(ref[1::2]).numpy()
    flipped = w != rw
    print(f"bf16 flips: intra-chunk weights {int(flipped.sum())} of "
          f"{w.size}, x*dt {int((xdt != rx).sum())} of {xdt.size}")
    # a flip moves a weight by at most one bf16 step; x * dt rounds alike
    np.testing.assert_array_less(np.abs(w - rw)[flipped],
                                 np.abs(rw)[flipped] * 2.0 ** -7)
    np.testing.assert_array_equal(xdt, rx)
    # the port's scan on the reference's rounded tensors: 1e-5
    np.testing.assert_allclose(sub_y, want_y, atol=TOL, rtol=0)
    np.testing.assert_allclose(sub_h, want_h, atol=TOL, rtol=0)
    np.testing.assert_allclose(got_h, want_h, atol=TOL, rtol=0)
    # the port's own output: within the flips' reach, 1e-5 elsewhere
    reach = np.einsum("cbijh,cbjhp->cbihp", np.abs(w - rw), np.abs(rx))
    reach = np.moveaxis(reach, 0, 1).reshape(got_y.shape)
    err = np.abs(got_y - want_y)
    assert (err <= reach * (1 + 1e-3) + TOL).all()
    assert err[reach == 0].max() <= TOL
