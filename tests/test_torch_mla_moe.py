"""The shared experts, two-scan specs and the bridge against the JAX
reference, on the CPU.

``moe_ffn`` with a ``shared`` subtree: the port's and the reference's take
the same float32 weights and tokens, made from a seed with numpy, with and
without a chunk ``token_mask`` (one with a wholly masked row), at capacity
factors 8.0 and 0.5, with planted top-k ties.  Outputs agree within 1e-5,
the aux loss within 1e-6, and the routing the reference's dispatch gets
(expert, capacity slot, ``keep``) bit for bit; the shared experts' output
is added on every token, padding included.  Two-scan programs (reduced
deepseek-v2-lite-16b, and ``attn_mlp`` + ``attn_moe``): ``param_specs``
and ``cache_specs`` (contiguous, and paged on fp and int8 pools) have the
reference's structure, stage by stage; the bridge round-trips the
reference's tree bit for bit, the nested ``shared`` subtree included; and
the published config at its full depth builds one ``MlaMlpBlock`` and 26
``MlaMoeBlock`` s, which ``quantize_for_serving`` refuses, naming items 11
and 16, while a program of two ``attn_mlp`` scans packs bit for bit as
the reference does, counting each stage's weights once.  One ``mla_moe``
block alone (stage 1's first, at factors 4.0
and 0.5) matches the reference's ``BLOCKS["mla_moe"].apply`` in modes
'chunk' and 'decode', output within 1e-5 and aux within 1e-6.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as ref_moe
from repro.models import ArchConfig as JaxCfg
from repro.core.quant import QuantConfig as JaxQuant
from repro.kernels.ops import PackedWeight as JaxPacked
from repro.models.common import ParamSpec as JaxSpec
from repro.models import init_paged_cache as jax_init_cache
from repro.models.blocks import BLOCKS as JAX_BLOCKS
from repro.models.model import cache_specs as jax_cache_specs
from repro.models.model import param_specs as jax_param_specs
from repro.models.model import quantize_for_serving as jax_quantize
from repro_torch.configs import get_config
from repro_torch.core.quant import QuantConfig
from repro_torch.launch.serve import parse_quant
from repro_torch.models import moe
from repro_torch.models.blocks import MlaMlpBlock, MlaMoeBlock
from repro_torch.models.common import ParamSpec
from repro_torch.models.config import ArchConfig
from repro_torch.models.model import (cache_specs, init_paged_cache,
                                      init_params, param_specs,
                                      quantize_for_serving)
from repro_torch.weights import from_jax_numpy, to_jax_numpy
from torch_mla_moe_cases import (B, D, E, F, FACTORS, K, MASKS,
                                 N_SHARED, S, TIES, configs, numpy_tree,
                                 unit_inputs)

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

FIELDS = dict(name="mla_moe_unit", family="moe", n_layers=1, d_model=D,
              n_heads=4, n_kv_heads=2, d_ff=0, vocab_size=64, n_experts=E,
              top_k=K, d_ff_expert=F, n_shared_experts=N_SHARED)


def _unit_configs(factor):
    return (JaxCfg(**FIELDS, capacity_factor=factor, dtype=jnp.float32),
            ArchConfig(**FIELDS, capacity_factor=factor,
                       dtype=torch.float32))


def _mask(name):
    lens = MASKS[name]
    if lens is None:
        return None
    return np.arange(S)[None, :] < np.asarray(lens)[:, None]


def _to_torch(p):
    return {k: _to_torch(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in p.items()}


def _reference(p, x, jc, mask, monkeypatch):
    """The reference's output, aux, and the routing its dispatch got."""
    seen = {}
    good = ref_moe._moe_dense_path

    def spy(p_, xf, idx_e, idx_c, keep, gate_vals, cap, cfg):
        seen.update(idx_e=np.asarray(idx_e), idx_c=np.asarray(idx_c),
                    keep=np.asarray(keep), cap=cap)
        return good(p_, xf, idx_e, idx_c, keep, gate_vals, cap, cfg)
    monkeypatch.setattr(ref_moe, "_moe_dense_path", spy)
    y, aux = ref_moe.moe_ffn(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                             jc, None if mask is None else jnp.asarray(mask))
    return np.asarray(y), float(aux), seen


@pytest.mark.parametrize("ties", TIES)
@pytest.mark.parametrize("factor", FACTORS)
@pytest.mark.parametrize("mask_name", sorted(MASKS))
def test_moe_ffn_with_shared_experts_matches_reference(mask_name, factor,
                                                       ties, monkeypatch):
    jc, tc = _unit_configs(factor)
    p, x = unit_inputs(ties)
    mask = _mask(mask_name)
    want, want_aux, ref = _reference(p, x, jc, mask, monkeypatch)
    tp, tx = _to_torch(p), torch.from_numpy(x)
    tm = None if mask is None else torch.from_numpy(mask)
    got, aux = moe.moe_ffn(tp, tx, tc, tm)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    assert abs(float(aux) - want_aux) <= 1e-6
    r = moe.route(tp, tx.reshape(B * S, D), tc, tm)
    assert r.cap == ref["cap"]
    np.testing.assert_array_equal(r.idx_e.numpy(), ref["idx_e"])
    np.testing.assert_array_equal(r.idx_c.numpy(), ref["idx_c"])
    np.testing.assert_array_equal(r.keep.numpy(), ref["keep"])
    # the shared experts' part is there on every token, padding included:
    # without it the output is the routed part alone
    routed = {k: v for k, v in tp.items() if k != "shared"}
    alone, _ = moe.moe_ffn(routed, tx, tc, tm)
    shared = moe._shared_experts(tp["shared"], tx.reshape(B * S, D), tc)
    np.testing.assert_allclose((got - alone).reshape(B * S, D).numpy(),
                               shared.numpy(), atol=1e-5, rtol=0)
    assert float(shared.abs().min(-1).values.max()) > 0
    if mask is not None:
        pad = ~torch.from_numpy(mask).reshape(-1)
        np.testing.assert_array_equal(
            got.reshape(B * S, D)[pad].numpy(), shared[pad].numpy())


@pytest.mark.parametrize("ties", TIES)
@pytest.mark.parametrize("factor", smoke.MLA_MOE_UNIT["factors"])
@pytest.mark.parametrize("mask_name", sorted(smoke.MLA_MOE_UNIT["masks"]))
def test_chip_unit_case_matches_reference(mask_name, factor, ties,
                                          monkeypatch):
    """``chip_smoke.py``'s phase-17 unit case (E 64, top 6, two shared
    experts; the card is held to the CPU port on it): the CPU port
    matches the reference's there too, routing bit for bit."""
    tp, tx, tc = smoke.moe_unit_case(torch, smoke.MLA_MOE_UNIT, ties,
                                     factor, "cpu")
    fields = {f: getattr(tc, f) for f in (
        "name", "family", "n_layers", "d_model", "n_heads", "n_kv_heads",
        "d_ff", "vocab_size", "n_experts", "top_k", "d_ff_expert",
        "n_shared_experts", "capacity_factor")}
    jc = JaxCfg(**fields, dtype=jnp.float32)
    lens = smoke.MLA_MOE_UNIT["masks"][mask_name]
    b, s = tx.shape[:2]
    mask = None if lens is None else \
        np.arange(s)[None, :] < np.asarray(lens)[:, None]
    p = jax.tree.map(lambda t: t.numpy(), tp)
    want, want_aux, ref = _reference(p, tx.numpy(), jc, mask, monkeypatch)
    tm = None if mask is None else torch.from_numpy(mask)
    got, aux = moe.moe_ffn(tp, tx, tc, tm)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    assert abs(float(aux) - want_aux) <= 1e-6
    r = moe.route(tp, tx.reshape(b * s, -1), tc, tm)
    assert r.cap == ref["cap"]
    np.testing.assert_array_equal(r.idx_e.numpy(), ref["idx_e"])
    np.testing.assert_array_equal(r.idx_c.numpy(), ref["idx_c"])
    np.testing.assert_array_equal(r.keep.numpy(), ref["keep"])
    assert (tc.n_experts, tc.top_k, tc.n_shared_experts) == (64, 6, 2)


def _structure(tree):
    """{path: (shape, dtype name or None, init)} of a spec tree, with the
    port's per-layer ``blocks`` list of each stage."""
    if isinstance(tree, (ParamSpec, JaxSpec)):
        dt = tree.dtype
        name = (None if dt is None else str(dt).split(".")[-1]
                if isinstance(dt, torch.dtype) else np.dtype(dt).name)
        return {"": (tuple(tree.shape), name, tree.init)}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        for path, leaf in _structure(v).items():
            out[f"/{k}{path}"] = leaf
    return out


def _restacked(specs, tc):
    """The port's param specs restacked as the reference lays them out:
    ``stages``, each leaf of a stage's first block with its layers
    leading."""
    from repro_torch.models.model import _stages
    blocks, stages = specs.pop("blocks"), []
    for n in (st.repeats for st in _stages(tc)):
        first = _structure(blocks[0])
        for b in blocks[1:n]:
            assert _structure(b) == first
        stages.append({p: ((n,) + s, d, i) for p, (s, d, i) in
                       first.items()})
        blocks = blocks[n:]
    out = _structure(specs)
    for j, st in enumerate(stages):
        out.update({f"/stages/{j}{p}": v for p, v in st.items()})
    return out


@pytest.mark.parametrize("case", ["deepseek", "two_scan"])
def test_param_specs_structure_equals_reference(case):
    jc, tc = configs(case)
    assert _restacked(param_specs(tc), tc) == _structure(
        jax_param_specs(jc))


@pytest.mark.parametrize("layout", ["contiguous", "fp", "int8"])
@pytest.mark.parametrize("case", ["deepseek", "two_scan"])
def test_cache_specs_structure_equals_reference(case, layout):
    jc, tc = configs(case)
    kw = ({} if layout == "contiguous" else
          dict(num_pages=12, page_size=4, kv_format=layout))
    want = jax_cache_specs(jc, 3, 256, **kw)
    got = cache_specs(tc, 3, 256, **kw)
    assert len(got) == len(want) == len(tc.pattern) == 2
    assert _structure(got) == _structure(want)


@pytest.mark.parametrize("case,f32", [("deepseek", True),
                                      ("deepseek", False),
                                      ("two_scan", True)])
def test_weight_bridge_round_trip_bit_exact(case, f32):
    jc, tc = configs(case, f32=f32)
    tree = numpy_tree(jc, seed=3)
    model = from_jax_numpy(tc, tree, device="cpu")
    kinds = [type(b).__name__ for b in model.blocks]
    if case.startswith("deepseek"):
        assert kinds == ["MlaMlpBlock", "MlaMoeBlock", "MlaMoeBlock"]
        sh = model.blocks[2].ffn["shared"]
        np.testing.assert_array_equal(
            sh["w_up"].float().numpy(),
            np.asarray(tree["stages"][1]["ffn"]["shared"]["w_up"][1],
                       np.float32))
    else:
        assert kinds == ["AttnMlpBlock", "AttnMoeBlock", "AttnMoeBlock"]
    back = to_jax_numpy(tc, model)
    la, ta = jax.tree.flatten(tree)
    lb, tb = jax.tree.flatten(back)
    assert ta == tb
    for a, b in zip(la, lb):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_published_deepseek_builds_its_27_blocks():
    """The published block program at its full depth and expert count
    (narrow widths, so that it fits the CPU test): one MlaMlpBlock, then
    26 MlaMoeBlocks, each with 64 experts and a ``shared`` subtree of
    the two shared experts' width."""
    full = get_config("deepseek-v2-lite-16b")
    assert full.pattern == (("scan", "mla_mlp", 1), ("scan", "mla_moe", 26))
    cfg = full.with_(d_model=32, n_heads=2, n_kv_heads=2, head_dim=0,
                     d_ff=48, vocab_size=64, d_ff_expert=8,
                     kv_lora_rank=16, qk_nope_dim=8, qk_rope_dim=4,
                     v_head_dim=8, dtype=torch.float32)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert len(params.blocks) == 27
    assert type(params.blocks[0]) is MlaMlpBlock
    assert all(type(b) is MlaMoeBlock for b in params.blocks[1:])
    for b in params.blocks[1:]:
        assert tuple(b.ffn["w_gate"].shape) == (64, 32, 8)
        assert tuple(b.ffn["shared"]["w_down"].shape) == (16, 32)
    assert "shared" not in params.blocks[0].ffn
    with pytest.raises(NotImplementedError,
                       match=r"item 11\).*ROADMAP queue 1 item 16"):
        quantize_for_serving(cfg.with_(quant=parse_quant("w4a16")), params)


@pytest.mark.parametrize("mode", ["chunk", "decode"])
@pytest.mark.parametrize("case", ["deepseek", "deepseek-0.5"])
def test_mla_moe_block_matches_reference(case, mode):
    """Stage 1's first block alone: the reference's
    ``BLOCKS["mla_moe"].apply`` and the port's ``MlaMoeBlock`` on the same
    hidden states, latent pool and page table."""
    jc, tc = configs(case)
    tree = numpy_tree(jc, seed=5)
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]), tree["stages"][1])
    block = from_jax_numpy(tc, tree, device="cpu").blocks[1]
    rng = np.random.RandomState(6)
    b, s = 3, (8 if mode == "chunk" else 1)
    x = rng.randn(b, s, tc.d_model).astype(np.float32)
    tbl = np.arange(12, dtype=np.int32).reshape(b, 4)
    pos = (np.array([8, 3, 0], np.int32) if mode == "chunk"
           else np.array([5, 4, 2], np.int32))
    jcache = jax.tree.map(lambda a: a[0], jax_init_cache(jc, b, 12, 4)[1])
    tcache = {k: v[0] for k, v in
              init_paged_cache(tc, 12, 4, device="cpu")[1].items()}
    jy, _, jaux = JAX_BLOCKS["mla_moe"].apply(
        jp, jnp.asarray(x), jc, jcache, mode, jnp.asarray(pos),
        jnp.asarray(tbl), None)
    with torch.inference_mode():
        ty, _, taux = block(torch.from_numpy(x), tcache, mode,
                            torch.from_numpy(pos), torch.from_numpy(tbl),
                            None, None)
    valid = (np.arange(s)[None] < pos[:, None]) if mode == "chunk" \
        else np.ones((b, 1), bool)
    np.testing.assert_allclose(ty.numpy()[valid], np.asarray(jy)[valid],
                               atol=1e-5, rtol=0)
    assert abs(float(taux) - float(jaux)) <= 1e-6


def test_two_stage_dense_program_packs_as_the_reference():
    """Only MLA and MoE stages refuse packing: ``attn_mlp`` x 1 +
    ``attn_mlp`` x 2 packs at w4a16 bit for bit as the reference's
    ``quantize_for_serving``, whose count takes each stage's eligible
    weights once (7 a stage) and ``lm_head``."""
    fields = dict(name="two_dense", family="dense", n_layers=3, d_model=64,
                  n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=100,
                  pattern=(("scan", "attn_mlp", 1), ("scan", "attn_mlp", 2)))
    jc = JaxCfg(**fields, quant=JaxQuant(mode="wo", a_bits=8, w_bits=4,
                                         use_kernel=False))
    tc = ArchConfig(**fields, quant=QuantConfig(mode="wo", a_bits=8,
                                                w_bits=4))
    tree = numpy_tree(jc)
    jpacked, jn = jax_quantize(jc, jax.tree.map(jnp.asarray, tree))
    tpacked, tn = quantize_for_serving(
        tc, from_jax_numpy(tc, tree, device="cpu"))
    assert tn == jn == 15

    def leaf(x):
        if isinstance(x, JaxPacked):
            return {"packed": np.asarray(x.packed),
                    "scale": np.asarray(x.scale), "k": x.k, "n": x.n,
                    "w_bits": x.w_bits}
        return np.asarray(x)
    want = jax.tree.map(leaf, jpacked,
                        is_leaf=lambda x: isinstance(x, JaxPacked))
    la, ta = jax.tree.flatten(want)
    lb, tb = jax.tree.flatten(to_jax_numpy(tc, tpacked))
    assert ta == tb
    for a, b in zip(la, lb):
        if isinstance(a, int):
            assert a == b
        else:
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
