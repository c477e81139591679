"""The port's MoE FFN against the JAX reference's, on the CPU.

``repro_torch.models.moe.moe_ffn`` and ``repro.models.moe.moe_ffn`` take
the same float32 weights and tokens, made from a seed with numpy, with
and without a chunk ``token_mask`` (one with a fully masked row), at
capacity factors 8.0 (no drops), 1.0 and 0.5 (most assignments dropped),
with planted top-k ties: two equal router columns, or tokens of zeros
whose eight router probabilities are all equal.  Outputs must agree
within 1e-5 and the aux loss within 1e-6; the routing the reference
hands its dispatch (each assignment's expert and capacity slot, ``keep``
and the gates) is read from its ``_moe_dense_path`` as it runs, and the
port's must equal it bit for bit, gates within 1e-6.  ``_capacity`` and
``_rank_in_group`` (with the sentinel expert) are held bitwise too.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as ref_moe
from repro.models import ArchConfig as JaxCfg
from repro_torch.models import moe
from repro_torch.models.config import ArchConfig
from torch_moe_cases import (B, D, E, F, FACTORS, K, MASKS, S, TIES,
                             unit_inputs)

FIELDS = dict(name="moe_unit", family="moe", n_layers=1, d_model=D,
              n_heads=4, n_kv_heads=2, d_ff=0, vocab_size=64, n_experts=E,
              top_k=K, d_ff_expert=F)


def _configs(factor):
    return (JaxCfg(**FIELDS, capacity_factor=factor, dtype=jnp.float32),
            ArchConfig(**FIELDS, capacity_factor=factor,
                       dtype=torch.float32))


def _mask(name):
    lens = MASKS[name]
    if lens is None:
        return None
    return np.arange(S)[None, :] < np.asarray(lens)[:, None]


def _reference(p, x, jc, mask, monkeypatch):
    """The reference's output, aux, and the routing its dispatch got."""
    seen = {}
    good = ref_moe._moe_dense_path

    def spy(p_, xf, idx_e, idx_c, keep, gate_vals, cap, cfg):
        seen.update(idx_e=np.asarray(idx_e), idx_c=np.asarray(idx_c),
                    keep=np.asarray(keep), gates=np.asarray(gate_vals),
                    cap=cap)
        return good(p_, xf, idx_e, idx_c, keep, gate_vals, cap, cfg)
    monkeypatch.setattr(ref_moe, "_moe_dense_path", spy)
    y, aux = ref_moe.moe_ffn({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x), jc,
                             None if mask is None else jnp.asarray(mask))
    return np.asarray(y), float(aux), seen


@pytest.mark.parametrize("ties", TIES)
@pytest.mark.parametrize("factor", FACTORS)
@pytest.mark.parametrize("mask_name", sorted(MASKS))
def test_moe_ffn_matches_reference(mask_name, factor, ties, monkeypatch):
    jc, tc = _configs(factor)
    p, x = unit_inputs(ties)
    mask = _mask(mask_name)
    want, want_aux, ref = _reference(p, x, jc, mask, monkeypatch)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    tx = torch.from_numpy(x)
    tm = None if mask is None else torch.from_numpy(mask)
    got, aux = moe.moe_ffn(tp, tx, tc, tm)
    r = moe.route(tp, tx.reshape(B * S, D), tc, tm)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    assert abs(float(aux) - want_aux) <= 1e-6
    assert r.cap == ref["cap"]
    np.testing.assert_array_equal(r.idx_e.numpy(), ref["idx_e"])
    np.testing.assert_array_equal(r.idx_c.numpy(), ref["idx_c"])
    np.testing.assert_array_equal(r.keep.numpy(), ref["keep"])
    np.testing.assert_allclose(r.gates.numpy(), ref["gates"], atol=1e-6,
                               rtol=0)
    # drops: routed assignments that found no slot, counted alike
    routed = np.ones(B * S * K, bool) if mask is None else \
        np.repeat(mask.reshape(-1), K)
    drops = int((~r.keep.numpy() & routed).sum())
    assert drops == int((~ref["keep"] & routed).sum())
    if factor == 8.0:
        assert drops == 0
    if factor == 0.5 and mask_name == "none":
        assert drops >= B * S * K - E * r.cap > 0


def test_ties_go_to_the_lower_expert():
    """A row of equal probabilities routes to experts 0..k-1, as
    ``jax.lax.top_k`` does (``torch.topk`` promises no order)."""
    _, tc = _configs(1.0)
    p, x = unit_inputs("row")
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    r = moe.route(tp, torch.from_numpy(x).reshape(B * S, D), tc)
    assert r.experts[2].tolist() == [0, 1]          # token (0, 2) is zeros
    assert r.gates[2].tolist() == [0.5, 0.5]


@pytest.mark.parametrize("e,k,factor", [(8, 2, 1.25), (32, 8, 1.25),
                                        (4, 2, 8.0), (64, 6, 0.5)])
def test_capacity_matches_reference(e, k, factor):
    ts = list(range(1, 2200)) + [2048 * 8, 4096 * 16]
    assert [moe._capacity(t, e, k, factor) for t in ts] == \
        [ref_moe._capacity(t, e, k, factor) for t in ts]


@pytest.mark.parametrize("n,e", [(120, 8), (1000, 32), (64, 4)])
def test_rank_in_group_matches_reference_with_the_sentinel(n, e):
    rng = np.random.RandomState(n)
    ids = rng.randint(0, e + 1, n)          # e is the sentinel expert
    ids[rng.rand(n) < 0.3] = e
    want = np.asarray(ref_moe._rank_in_group(jnp.asarray(ids, jnp.int32)))
    got = moe._rank_in_group(torch.from_numpy(ids.astype(np.int64)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_shared_experts_raise_naming_item_12b(monkeypatch):
    """A ``shared`` subtree was refused before item 12b; the shared
    experts now run beside the routed ones, and the unit case with two
    of them (at factor 1.0) matches the reference's output, aux and
    routing."""
    fields = dict(FIELDS, n_shared_experts=2)
    jc = JaxCfg(**fields, capacity_factor=1.0, dtype=jnp.float32)
    tc = ArchConfig(**fields, capacity_factor=1.0, dtype=torch.float32)
    p, x = unit_inputs("columns")
    rng = np.random.RandomState(1)
    p["shared"] = {"w_gate": rng.randn(D, 2 * F) / np.sqrt(D),
                   "w_up": rng.randn(D, 2 * F) / np.sqrt(D),
                   "w_down": rng.randn(2 * F, D) / np.sqrt(2 * F)}
    p["shared"] = {k: v.astype(np.float32) for k, v in p["shared"].items()}
    seen = {}
    good = ref_moe._moe_dense_path

    def spy(p_, xf, idx_e, idx_c, keep, gate_vals, cap, cfg):
        seen.update(idx_e=np.asarray(idx_e), keep=np.asarray(keep))
        return good(p_, xf, idx_e, idx_c, keep, gate_vals, cap, cfg)
    monkeypatch.setattr(ref_moe, "_moe_dense_path", spy)
    jp = {k: ({n: jnp.asarray(w) for n, w in v.items()}
              if isinstance(v, dict) else jnp.asarray(v))
          for k, v in p.items()}
    want, want_aux = ref_moe.moe_ffn(jp, jnp.asarray(x), jc)
    tp = {k: ({n: torch.from_numpy(w) for n, w in v.items()}
              if isinstance(v, dict) else torch.from_numpy(v))
          for k, v in p.items()}
    got, aux = moe.moe_ffn(tp, torch.from_numpy(x), tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    assert abs(float(aux) - float(want_aux)) <= 1e-6
    r = moe.route(tp, torch.from_numpy(x).reshape(B * S, D), tc)
    np.testing.assert_array_equal(r.idx_e.numpy(), seen["idx_e"])
    np.testing.assert_array_equal(r.keep.numpy(), seen["keep"])
