"""Configs and weights shared by the port's tests of the hybrid family (a
helper, not collected): float32 (jax config, port config) pairs of
reduced zamba2-7b (a group stage of 2 x (2 ``mamba`` + 1
``shared_attn``), then a scan of 2 ``mamba``), and of the reference's
continuous-batching family configs ``hybrid`` (a group of 2 x (``mamba``
+ ``shared_attn``)) and ``ssm`` (a scan of 2 ``mamba``); the reference's
init as numpy arrays, with the leaves it initialises to constants
(``A_log``, ``D``, ``dt_bias``, ``conv_b`` and the norms) drawn from the
seed instead, so that none is an identity; and the means to count the
bf16 flips of the SSD scan and feed the port the reference's rounding
(below)."""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.models.ssm as ref_ssm
from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce
from repro.models import ArchConfig as JaxCfg
from repro.models import init_params as jax_init_params
from repro_torch.configs import get_config, reduce_config
from repro_torch.models import ssm
from repro_torch.models.config import ArchConfig

ZAMBA = "zamba2-7b"
# tests/test_continuous_batching.py's FAMILY_CFGS["hybrid"] and ["ssm"]
FAMILY = {
    "hybrid": dict(name="cb_hyb", family="hybrid", n_layers=4, d_model=64,
                   n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=100,
                   ssm_state=16, ssm_headdim=32, ssm_chunk=4,
                   decode_margin=32,
                   pattern=(("group", (("mamba", 1), ("shared_attn", 1)),
                             2),)),
    "ssm": dict(name="cb_ssm", family="ssm", n_layers=2, d_model=64,
                n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=100,
                ssm_state=16, ssm_headdim=32, ssm_chunk=4, decode_margin=32,
                pattern=(("scan", "mamba", 2),)),
}
CASES = ("zamba2", "hybrid", "ssm")
# the leaves the reference initialises to constants
DRAWN = {"A_log": (0.0, 0.5), "D": (1.0, 0.1), "dt_bias": (0.0, 0.5),
         "conv_b": (0.0, 0.1), "norm": (1.0, 0.1), "w": (1.0, 0.1)}


def configs(case):
    """(jax config, port config) of ``case``, float32."""
    if case == "zamba2":
        return (jax_reduce(jax_get_config(ZAMBA)).with_(dtype=jnp.float32),
                reduce_config(get_config(ZAMBA)).with_(dtype=torch.float32))
    return (JaxCfg(**FAMILY[case], dtype=jnp.float32),
            ArchConfig(**FAMILY[case], dtype=torch.float32))


def config_fields(case):
    """The port config of ``case`` as ArchConfig keyword arguments (for
    ``tests/torch_swap_lockstep.py``, which builds both configs from one
    dict)."""
    _, tc = configs(case)
    fields = {f: getattr(tc, f) for f in (
        "name", "family", "n_layers", "d_model", "n_heads", "n_kv_heads",
        "head_dim", "d_ff", "vocab_size", "ssm_state", "ssm_headdim",
        "ssm_expand", "ssm_chunk", "conv_dim", "pattern", "decode_margin")}
    fields["name"] = f"{tc.name}_{case}"
    return fields


def numpy_tree(jc, seed=0):
    """The reference's init of ``jc`` as numpy arrays, the constant leaves
    of ``DRAWN`` drawn as mean + std * N(0, 1) from ``seed``."""
    rng = np.random.RandomState(seed + 1000)

    def draw(path, a):
        name = getattr(path[-1], "key", None)
        if name not in DRAWN:
            return np.asarray(a)
        mean, std = DRAWN[name]
        return (mean + std * rng.randn(*a.shape)).astype(a.dtype)
    return jax.tree_util.tree_map_with_path(
        draw, jax_init_params(jc, jax.random.PRNGKey(seed)))


# -- swap preemption (tests/test_torch_hybrid_swap*.py) ----------------------
SHARED = [5, 7, 11, 2, 9, 4, 8, 1]
SWAP_PROMPTS = [SHARED + [6], [3, 1, 4, 1, 5, 9], SHARED + [3, 2]]
SWAP_SERVE = dict(max_batch=2, max_prompt=8, max_new_tokens=12, page_size=4,
                  max_seq=24, num_pages=8, reserve_decode_pages=False)


def _swap_plans():
    from torch_swap_lockstep import MID_PROMPT, MID_PROMPT_PLAN, plan_of
    return {"cycle": (SWAP_SERVE, plan_of(SWAP_PROMPTS)),
            "mid_prompt": (MID_PROMPT, MID_PROMPT_PLAN)}


SWAP_PLANS = ("cycle", "mid_prompt")


def swap_case(case, plan):
    """``Lockstep`` (fed the reference's scan rounding) on ``plan``: at
    least one preemption, every swap-in checked bit for bit (pages and
    state rows), no prefix shared, a snapshot carrying each mamba
    block's conv and SSM rows, every request complete, every page free."""
    from torch_swap_lockstep import Lockstep
    serve_kw, requests = _swap_plans()[plan]
    ls = Lockstep(config_fields(case), serve_kw, requests, scans=True).run()
    print(f"{case} {plan}: {ls.flips} bf16 flips in the scans")
    te = ls.te
    assert te.n_preemptions > 0
    assert ls.restores == te.n_swap_ins == te.n_preemptions
    assert te.n_shared_admissions == 0 == ls.je.n_shared_admissions
    assert te._slot_state_nbytes > 0 and len(te._state_leaves()) >= 2
    assert all(not r.failed and len(r.out_tokens) == serve_kw[
        "max_new_tokens"] for r in ls.treq.values())
    ls.drained()


# -- bf16 flips in the SSD scan ----------------------------------------------
# The scan rounds its intra-chunk weights and x * dt to bfloat16 (both
# packages).  An ulp of float32 difference before the rounding (the
# cumsum's order, exp, C . B) can put one weight on the other bf16
# neighbour: a flip, worth ~2^-9 of the weight, which breaks 1e-5 on the
# rows it feeds.  The tests count the flips and hold the port fed the
# reference's own rounded tensors to 1e-5 instead of widening a bound.

def rounded_inputs(xh, dt, a, b_in, c_in, l):
    """The reference's bf16-rounded intra-chunk weights and x * dt of one
    SSD scan, chunk by chunk, op for op in jnp, widened to float32 torch
    tensors: the list the port's ``ssm._bf16`` sees, in its call order
    (a chunk's weights, then its x * dt)."""
    out = []
    for lo in range(0, xh.shape[1], l):
        xc, dtc, ac = xh[:, lo:lo + l], dt[:, lo:lo + l], a[:, lo:lo + l]
        bc, cc = b_in[:, lo:lo + l], c_in[:, lo:lo + l]
        cum = jnp.cumsum(ac.astype(jnp.float32), axis=1)
        seg = cum[:, :, None, :] - cum[:, None, :, :]
        causal = jnp.tril(jnp.ones((l, l), bool))
        decay = jnp.where(causal[None, :, :, None], jnp.exp(seg), 0.0)
        cb = jnp.einsum("bin,bjn->bij", cc.astype(jnp.float32),
                        bc.astype(jnp.float32))
        w = (cb[..., None] * decay).astype(jnp.bfloat16)
        xdt = (xc.astype(jnp.float32) * dtc.astype(jnp.float32)[..., None]
               ).astype(jnp.bfloat16)
        out += [torch.from_numpy(np.asarray(v.astype(jnp.float32)))
                for v in (w, xdt)]
    return out


@contextlib.contextmanager
def reference_scans(calls):
    """Run the reference eagerly (``jax.disable_jit``: its scans unroll
    into Python loops) and append every SSD scan's inputs to ``calls``;
    afterwards ``reference_roundings(calls)`` gives its rounded
    tensors."""
    good = ref_ssm._ssd_chunked

    def spy(*args):
        calls.append(args)
        return good(*args)
    ref_ssm._ssd_chunked = spy
    try:
        with jax.disable_jit():
            yield
    finally:
        ref_ssm._ssd_chunked = good


def reference_roundings(calls):
    """The rounded tensors of the recorded reference scans, in order."""
    return [t for xh, dt, a, b_in, c_in, _, chunk in calls
            for t in rounded_inputs(xh, dt, a, b_in, c_in,
                                    ssm.chunk_len(xh.shape[1], chunk))]


@contextlib.contextmanager
def port_roundings(record=None, feed=None):
    """The port's scans append their own rounded tensors to ``record``
    and, with ``feed`` (``reference_roundings``), use the reference's
    instead, each of the shape the port's would have, and all of them.
    Fed, the port's inputs to each rounding track the reference's to
    float32's error, so ``count_flips(record, feed)`` counts the flips
    themselves, not their consequences downstream."""
    good = ssm._bf16
    it = iter(feed) if feed is not None else None

    def fn(t):
        if record is not None:
            record.append(good(t))
        if it is None:
            return record[-1]
        r = next(it)
        assert tuple(r.shape) == tuple(t.shape), (r.shape, t.shape)
        return r.to(t.device)
    ssm._bf16 = fn
    try:
        yield
        if it is not None:
            assert next(it, None) is None, "reference scans left unused"
    finally:
        ssm._bf16 = good


def count_flips(mine, ref) -> int:
    """Rounded values that differ between the port's and the reference's
    rounded tensors (a scan's chunks in turn: weights (B, L, L, H), then
    x * dt (B, L, H, P)), at live steps only: a step whose x * dt is 0
    throughout (dt = 0: chunk padding, or a slot not in the wave, whose
    input rows carry whatever the attention made of a row with no key,
    and never reach a live row) is left out.  Each counted value lies
    within one bf16 step of the reference's, give or take float32's
    error on the tensor's scale (1e-6 of its largest value: a value near
    0 carries the absolute error of the sums before it, and XLA on the
    CPU flushes subnormals to zero)."""
    assert len(mine) == len(ref) and len(ref) % 2 == 0
    n = 0
    for i in range(0, len(ref), 2):
        live = (ref[i + 1] != 0).flatten(2).any(-1)            # (B, L)
        masks = (live[:, :, None, None] & live[:, None, :, None],
                 live[:, :, None, None])
        for m, r, keep in zip(mine[i:i + 2], ref[i:i + 2], masks):
            d = (m != r) & keep
            if d.any():
                dm, dr = m[d], r[d]
                reach = torch.maximum(dm.abs(), dr.abs()) * 2.0 ** -7 + \
                    1e-6 * r.abs().max()
                assert bool(((dm - dr).abs() <= reach).all()), \
                    "a rounding more than one bf16 step apart"
                n += int(d.sum())
    return n
