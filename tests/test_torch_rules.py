"""Rules the port keeps: no JAX, no code of the JAX package, no silent CPU
fallback, and visible rejection of what this slice does not serve."""
import contextlib
import io
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config, reduce_config
from repro_torch.models.config import ArchConfig
from repro_torch.core.pageformat import get_format
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import mpq_matmul as mm
from repro_torch.kernels import paged_flash_decode as pfd
from repro_torch.launch import serve as launcher
from repro_torch.models.attention import paged_kv_cache_spec
from repro_torch.models.mla import paged_mla_cache_spec
from repro_torch.models import vision
from repro_torch.models.model import (init_paged_cache, init_params,
                                      quantize_for_serving)
from repro_torch.serve import Request, ServeConfig, ServingEngine
from repro_torch.weights import from_jax_numpy, vision_from_jax_numpy

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_importing_the_port_loads_neither_jax_nor_repro():
    code = (
        "import importlib, pkgutil, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__,\n"
        "                               'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro',"
        " 'jaxlib')]\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]),"
        " bad)\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.split(" ", 1)
    assert int(n) > 15 and bad.strip() == "[]", out.stdout


def test_no_source_file_imports_jax_or_repro():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)",
                     re.M)
    files = list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                       ROOT / "int_row_errors.py"]
    assert len(files) > 15
    hits = [str(f) for f in files if pat.search(f.read_text())]
    assert not hits, hits


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_engine_default_device_raises_without_a_card(no_card):
    cfg = reduce_config(get_config("qwen2.5-3b"))
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="is_available"):
        ServingEngine(cfg, params, ServeConfig())


@pytest.mark.parametrize("entry", ["init_params", "init_paged_cache",
                                   "from_jax_numpy", "launcher",
                                   "init_vision", "vision_from_jax_numpy"])
def test_entry_points_default_to_cuda_and_raise_without_it(no_card, entry):
    cfg = reduce_config(get_config("stablelm-3b"))
    calls = {
        "init_params": lambda: init_params(cfg),
        "init_paged_cache": lambda: init_paged_cache(cfg, 4, 16),
        "from_jax_numpy": lambda: from_jax_numpy(cfg, {}),
        "launcher": lambda: launcher.main(["--arch", "stablelm-3b",
                                           "--reduce"]),
        "init_vision": lambda: vision.init_vision(vision.resnet20_specs()),
        "vision_from_jax_numpy": lambda: vision_from_jax_numpy({}),
    }
    with pytest.raises(RuntimeError, match="is_available"):
        calls[entry]()


def test_kernel_wrapper_has_no_fallback_off_the_cpu():
    q = torch.empty(1, 4, 2, 32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fa.flash_attention(q, q, q)


def test_no_port_file_mentions_the_kernel_switch():
    """The reference's QuantConfig switch between kernel and oracle has no
    counterpart: the wrappers choose by device, so no field can lead a
    CUDA tensor to a plain version."""
    files = list(PKG.rglob("*.py")) + list(PKG.rglob("*.cu")) + \
        list(PKG.rglob("*.cuh")) + [ROOT / "chip_smoke.py",
                                    ROOT / "int_row_errors.py"]
    hits = [str(f) for f in files if "use_kernel" in f.read_text()]
    assert not hits, hits


def _mm_operands(device):
    wp = torch.zeros(32, 8, dtype=torch.int8, device=device)
    ws = torch.ones(1, 8, device=device)
    return wp, ws


def test_packed_matmuls_on_the_cpu_never_touch_the_build(monkeypatch):
    def no_build(*a, **k):
        raise AssertionError("the build was reached from a CPU tensor")
    monkeypatch.setattr(_build, "load", no_build)
    monkeypatch.setattr(_build, "build_all", no_build)
    wp, ws = _mm_operands("cpu")
    before = mm.launches
    y = mm.wo_matmul(torch.ones(3, 64), wp, ws, w_bits=4)
    z = mm.mpq_matmul(torch.ones(3, 64, dtype=torch.int8), torch.ones(3, 1),
                      wp, ws, a_bits=8, w_bits=4)
    assert y.shape == z.shape == (3, 8) and mm.launches == before


def test_packed_matmuls_have_no_fallback_off_the_cpu():
    wp, ws = _mm_operands("meta")
    with pytest.raises(ValueError, match="no kernel"):
        mm.wo_matmul(torch.empty(3, 64, device="meta"), wp, ws, w_bits=4)
    with pytest.raises(ValueError, match="no kernel"):
        mm.mpq_matmul(torch.empty(3, 64, dtype=torch.int8, device="meta"),
                      torch.empty(3, 1, device="meta"), wp, ws, a_bits=8,
                      w_bits=4)


@pytest.mark.parametrize("field,value", [
    ("temperature", 0.7),
    ("host_pool_pages", 8), ("spec_draft", "self"), ("decode_sharing", True),
    ("spill_dir", "/tmp/spill")])
def test_serve_config_rejects_unserved_knobs(field, value):
    """Each knob of a later item raises naming it; ``temperature`` was
    one (item 7) and is served now, with ``ServeConfig.seed``."""
    if field == "temperature":
        sc = ServeConfig(**{field: value}, seed=5)
        assert (sc.temperature, sc.seed) == (value, 5)
        return
    with pytest.raises(ValueError,
                       match=rf"ServeConfig\.{field} .*ROADMAP queue 1 item"):
        ServeConfig(**{field: value})


def test_oversized_prompt_is_rejected_visibly():
    cfg = reduce_config(get_config("qwen2.5-3b"))
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    eng = ServingEngine(cfg, params, ServeConfig(max_prompt=8, max_seq=24,
                                                 max_new_tokens=4),
                        device="cpu")
    with pytest.raises(ValueError, match=r"Request\.prompt .*ROADMAP"):
        eng.submit(Request(0, list(range(21))))
    eng.submit(Request(1, list(range(20))))     # at the limit: served
    assert [len(r.out_tokens) for r in eng.drain()] == [4]


def test_chip_smoke_fails_without_a_card():
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         env=_env(), capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_alone_in_a_directory(tmp_path):
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, str(alone)], capture_output=True,
                         text=True, timeout=120, cwd=tmp_path)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


# -- MLA ----------------------------------------------------------------------

def _prefill_matches_reference(tc):
    """The float32 port config ``tc`` and its reference twin, on the
    reference's init bridged: 'prefill' of a (2, 6) prompt into a
    contiguous cache, logits within 1e-5 and aux within 1e-6."""
    import dataclasses
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro.models import ArchConfig as JaxCfg
    from repro.models import forward as jax_forward
    from repro.models import init_cache as jax_init_cache
    from repro.models import init_params as jax_init_params
    from repro_torch.models.model import forward, init_cache
    fields = {f.name: getattr(tc, f.name) for f in dataclasses.fields(tc)
              if f.name not in ("dtype", "quant")}
    jc = JaxCfg(**fields, dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, jax_init_params(jc, jax.random.PRNGKey(0)))
    toks = np.random.RandomState(0).randint(0, tc.vocab_size, (2, 6))
    jl, _, jaux = jax_forward(jax.tree.map(jnp.asarray, tree),
                              jnp.asarray(toks, jnp.int32), jc,
                              cache=jax_init_cache(jc, 2, 6), mode="prefill")
    with torch.inference_mode():
        tl, _, taux = forward(from_jax_numpy(tc, tree, device="cpu"),
                              torch.from_numpy(toks), tc,
                              cache=init_cache(tc, 2, 6, device="cpu"),
                              mode="prefill")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=0)
    assert abs(float(taux) - float(jaux)) <= 1e-6


def test_real_deepseek_v2_lite_raises_naming_the_moe_item():
    """deepseek-v2-lite-16b (an mla_mlp block, then mla_moe blocks with
    shared experts) was refused before its MoE blocks were ported; it is
    now served: reduced, it builds its two stages, its paged cache has
    the reference's stages and shapes, and its forward matches the
    reference's."""
    from repro.configs import get_config as jax_get_config
    from repro.configs import reduce_config as jax_reduce
    from repro.models import init_paged_cache as jax_init_paged_cache
    cfg = reduce_config(get_config("deepseek-v2-lite-16b"))
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert [type(b).__name__ for b in params.blocks] == [
        "MlaMlpBlock", "MlaMoeBlock", "MlaMoeBlock"]
    assert "shared" in params.blocks[1].ffn
    got = init_paged_cache(cfg, 4, 16, device="cpu")
    want = jax_init_paged_cache(jax_reduce(jax_get_config(
        "deepseek-v2-lite-16b")), 2, 4, 16)
    assert [{k: tuple(v.shape) for k, v in st.items()} for st in got] == \
        [{k: tuple(v.shape) for k, v in st.items()} for st in want]
    _prefill_matches_reference(cfg.with_(dtype=torch.float32))


# -- MoE ----------------------------------------------------------------------

def test_packed_moe_weights_are_rejected():
    """The reference keeps MoE expert banks raw under its fake-quant
    emulation, which the port does not have (item 16)."""
    cfg = reduce_config(get_config("granite-moe-1b-a400m"))
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    cfg = cfg.with_(quant=launcher.parse_quant("w4a16"))
    with pytest.raises(NotImplementedError, match=r"ROADMAP queue 1 item 16"):
        quantize_for_serving(cfg, params)


MOE_FIELDS = dict(name="m", family="moe", n_layers=2, d_model=32,
                  n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=64,
                  n_experts=4, top_k=2, d_ff_expert=16)


@pytest.mark.parametrize("pattern", [
    (("scan", "mla_moe", 2),),
    (("scan", "attn_mlp", 1), ("scan", "attn_moe", 1)),
    (("scan", "attn_moe", 1), ("scan", "attn_moe", 1))])
def test_mla_moe_and_two_stage_programs_raise_naming_item_12(pattern):
    """Programs of mla_moe blocks or of two scans were refused before
    item 12b; each now builds a block a layer, in its stages' order, and
    its forward matches the reference's."""
    cfg = ArchConfig(**MOE_FIELDS, kv_lora_rank=16, pattern=pattern)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    kinds = [kind for _, kind, n in pattern for _ in range(n)]
    assert [type(b).__name__ for b in params.blocks] == [
        {"mla_moe": "MlaMoeBlock", "attn_mlp": "AttnMlpBlock",
         "attn_moe": "AttnMoeBlock"}[k] for k in kinds]
    _prefill_matches_reference(cfg.with_(dtype=torch.float32))


@pytest.mark.parametrize("pattern,mode", [
    ((("group", (("mamba", 1), ("attn_mlp", 1)), 1),), "tokens"),
    ((("scan", "mamba", 2),), "tokens"),
    ((("scan", "mlstm", 1), ("scan", "attn_mlp", 1)), "tokens"),
    ((("scan", "attn_mlp", 2),), "embeds")])
def test_group_and_recurrent_programs_raise_naming_item_13(pattern, mode):
    """xLSTM blocks and embeds input raise naming item 13.  A group stage
    and mamba blocks raised too before item 13a; each such program now
    builds its blocks in the reference's order, a paged cache of pools
    beside per-slot state (which needs ``batch``), and its 'prefill'
    forward matches the reference's."""
    kinds = {k for e in pattern for k in (
        [e[1]] if e[0] == "scan" else [k for k, _ in e[1]])}
    if mode == "tokens" and "mlstm" not in kinds:
        cfg = ArchConfig(**MOE_FIELDS, pattern=pattern, ssm_state=8,
                         ssm_headdim=16)
        params = init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
        assert [type(b).__name__ for b in params.blocks] == (
            ["MambaBlock", "AttnMlpBlock"] if pattern[0][0] == "group"
            else ["MambaBlock"] * 2)
        with pytest.raises(ValueError, match="needs batch"):
            init_paged_cache(cfg, 4, 16, device="cpu")
        cache = init_paged_cache(cfg, 4, 16, batch=3, device="cpu")
        assert cache[0]["b0" if pattern[0][0] == "group" else "conv"] \
            is not None
        _prefill_matches_reference(cfg.with_(dtype=torch.float32))
        return
    cfg = ArchConfig(**MOE_FIELDS, pattern=pattern, input_mode=mode)
    with pytest.raises(ValueError, match=r"ROADMAP queue 1 item 13"):
        init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match=r"ROADMAP queue 1 item 13"):
        init_paged_cache(cfg, 4, 16, device="cpu")


def test_moe_family_config_has_one_attn_moe_scan():
    """``family="moe"`` with ``d_ff=0`` (the reference's FAMILY_CFGS
    config) derives one scan of attn_moe blocks and is served."""
    cfg = ArchConfig(**dict(MOE_FIELDS, d_ff=0))
    assert cfg.pattern == (("scan", "attn_moe", 2),)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert tuple(params.blocks[1].ffn["w_up"].shape) == (4, 32, 16)
    assert "w_gate" in params.blocks[0].ffn and \
        "shared" not in params.blocks[0].ffn


def test_launcher_serves_granite_reduced_on_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launcher.main(["--arch", "granite-moe-1b-a400m", "--reduce",
                       "--device", "cpu", "--requests", "3",
                       "--max-batch", "2", "--max-new-tokens", "4"])
    lines = out.getvalue().splitlines()
    assert sum(ln.startswith("req ") and "[done" in ln for ln in lines) == 3


def test_launcher_serves_deepseek_reduced_on_cpu():
    """The published deepseek-v2-lite-16b (reduced) through the serving
    launcher; ``--quant`` refuses it, naming items 11 and 16."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launcher.main(["--arch", "deepseek-v2-lite-16b", "--reduce",
                       "--device", "cpu", "--requests", "3",
                       "--max-batch", "2", "--max-new-tokens", "4"])
    lines = out.getvalue().splitlines()
    assert sum(ln.startswith("req ") and "[done" in ln for ln in lines) == 3
    with pytest.raises(NotImplementedError,
                       match=r"item 11\).*ROADMAP queue 1 item 16"):
        launcher.main(["--arch", "deepseek-v2-lite-16b", "--reduce",
                       "--device", "cpu", "--quant", "w4a16"])


def test_launcher_serves_zamba2_reduced_on_cpu():
    """zamba2-7b (reduced: a group of 2 x (2 mamba + the shared block),
    then 2 mamba) through the serving launcher; ``--quant`` refuses it,
    naming item 13."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launcher.main(["--arch", "zamba2-7b", "--reduce", "--device", "cpu",
                       "--requests", "3", "--max-batch", "2",
                       "--max-new-tokens", "4"])
    lines = out.getvalue().splitlines()
    assert sum(ln.startswith("req ") and "[done" in ln for ln in lines) == 3
    with pytest.raises(NotImplementedError,
                       match=r"Mamba2.*ROADMAP queue 1 item 13"):
        launcher.main(["--arch", "zamba2-7b", "--reduce", "--device", "cpu",
                       "--quant", "w4a16"])


def test_packed_mla_weights_are_rejected():
    cfg = reduce_config(get_config("deepseek-v2-lite-dense"))
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    cfg = cfg.with_(quant=launcher.parse_quant("w4a16"))
    with pytest.raises(NotImplementedError, match=r"ROADMAP queue 1 item 11"):
        quantize_for_serving(cfg, params)


def test_unknown_kv_format_raises_naming_the_formats():
    with pytest.raises(ValueError, match=r"ServeConfig\.kv_format must be "
                       r"one of \('fp', 'int8', 'int4'\), got 'fp8'"):
        ServeConfig(kv_format="fp8")


@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_quantized_pools_are_served(fmt):
    """The quantized KV pool is in the port: ServeConfig takes it, and
    both cache specs give int8 pools beside float32 row scales."""
    assert ServeConfig(kv_format=fmt).kv_format == fmt
    pf = get_format(fmt)
    for cfg, spec in (
            (reduce_config(get_config("qwen2.5-3b")), paged_kv_cache_spec),
            (reduce_config(get_config("deepseek-v2-lite-dense")),
             paged_mla_cache_spec)):
        leaves = spec(cfg, 4, 16, fmt=pf)
        assert {k: v.dtype for k, v in leaves.items()
                if not k.endswith("_scale")} == \
            {k: torch.int8 for k in leaves if not k.endswith("_scale")}
        assert [v.shape for k, v in leaves.items() if k.endswith("_scale")]
        assert all(v.shape == (4, 16) and v.dtype == torch.float32
                   for k, v in leaves.items() if k.endswith("_scale"))


def _quant_operands(device):
    """Quantized GQA (int4, dh 128) and MLA (int8) operands."""
    z = lambda *s, dt=torch.float32: torch.zeros(  # noqa: E731
        *s, dtype=dt, device=device)
    gqa = (z(4, 16, 2, 64, dt=torch.int8), z(4, 16, 2, 64, dt=torch.int8),
           z(2, 1, 4, 128), z(2, 2, dt=torch.int32),
           z(2, 1, dt=torch.int32), z(2, dt=torch.int32))
    mla = (z(4, 16, 576, dt=torch.int8), z(2, 1, 16, 512), z(2, 1, 16, 64),
           z(2, 2, dt=torch.int32), z(2, dt=torch.int32))
    return gqa, dict(k_scale=z(4, 16), v_scale=z(4, 16), bits=4), \
        mla, dict(scale_pool=z(4, 16), bits=8)


def test_quant_partials_on_the_cpu_never_touch_the_build(monkeypatch):
    def no_build(*a, **k):
        raise AssertionError("the build was reached from a CPU tensor")
    monkeypatch.setattr(_build, "load", no_build)
    monkeypatch.setattr(_build, "build_all", no_build)
    gqa, gkw, mla, mkw = _quant_operands("cpu")
    before = (pfd.quant_launches, pfd.mla_quant_launches)
    m, l, acc = pfd.paged_flash_decode_partials(*gqa, **gkw)
    assert tuple(acc.shape) == (2, 1, 2, 2, 2, 128)
    m, l, acc = pfd.mla_paged_decode_partials(*mla, 512, 192, **mkw)
    assert tuple(acc.shape) == (2, 1, 16, 2, 512)
    assert (pfd.quant_launches, pfd.mla_quant_launches) == before


def test_quant_partials_have_no_fallback_off_the_cpu():
    gqa, gkw, mla, mkw = _quant_operands("meta")
    with pytest.raises(ValueError, match="no kernel"):
        pfd.paged_flash_decode_partials(*gqa, **gkw)
    with pytest.raises(ValueError, match="no kernel"):
        pfd.mla_paged_decode_partials(*mla, 512, 192, **mkw)


def _mla_operands(device, dtype=torch.float32):
    pool = torch.zeros(4, 16, 576, dtype=dtype, device=device)
    q_c = torch.zeros(2, 1, 16, 512, dtype=dtype, device=device)
    q_r = torch.zeros(2, 1, 16, 64, dtype=dtype, device=device)
    tbl = torch.zeros(2, 2, dtype=torch.int32, device=device)
    pos = torch.zeros(2, dtype=torch.int32, device=device)
    return pool, q_c, q_r, tbl, pos


def test_mla_partials_on_the_cpu_never_touch_the_build(monkeypatch):
    def no_build(*a, **k):
        raise AssertionError("the build was reached from a CPU tensor")
    monkeypatch.setattr(_build, "load", no_build)
    monkeypatch.setattr(_build, "build_all", no_build)
    before = pfd.mla_launches
    m, l, acc = pfd.mla_paged_decode_partials(*_mla_operands("cpu"), 512,
                                              192)
    assert tuple(acc.shape) == (2, 1, 16, 2, 512)
    assert pfd.mla_launches == before


def test_mla_partials_have_no_fallback_off_the_cpu():
    with pytest.raises(ValueError, match="no kernel"):
        pfd.mla_paged_decode_partials(*_mla_operands("meta"), 512, 192)
