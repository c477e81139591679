"""The port's KV page formats against the JAX reference, on the CPU.

``repro_torch.core.pageformat`` and ``core.quant.quantize_page_rows``
against ``repro.core.pageformat`` on the same numpy rows:

  * packed bytes and row scales bitwise equal to the reference's EAGER
    ``PageFormat.quantize_rows``, at a GQA head row (2 x 128) and an MLA
    latent row (576), float32 and bfloat16, int8 and int4; dequantized
    rows bitwise equal too;
  * int4 is strided across the split at r: byte j of a latent row holds
    element j and element j + 288, so k_rope (512-575) is the high
    nibbles of bytes 224-287;
  * under ``jax.jit`` XLA computes ``amax / qmax`` as ``amax * (1 /
    qmax)``: the jitted scales may differ by one ulp and the integers by
    one step, no more (a difference between frameworks, counted in
    ROADMAP queue 3);
  * ``get_format`` / ``format_for_packed`` / ``packed_feat`` errors, and
    the cache specs' leaves, shapes and dtypes equal the reference's.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import pageformat as jpf
from repro.models import ArchConfig as JaxCfg
from repro.models import init_paged_cache as jax_init_cache
from repro.models.attention import paged_kv_cache_spec as jax_kv_spec
from repro.models.mla import paged_mla_cache_spec as jax_mla_spec
from repro_torch.core import pageformat as tpf
from repro_torch.core.packing import unpack
from repro_torch.models.attention import cache_page_format, \
    paged_kv_cache_spec
from repro_torch.models.config import ArchConfig
from repro_torch.models.mla import paged_mla_cache_spec
from repro_torch.models.model import init_paged_cache

GQA = dict(name="pg", family="dense", n_layers=2, d_model=64, n_heads=4,
           n_kv_heads=2, d_ff=128, vocab_size=100, decode_margin=32)
MLA = dict(name="pg_mla", family="dense", n_layers=2, d_model=64,
           n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=100,
           kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
           decode_margin=32, pattern=(("scan", "mla_mlp", 2),))
WIDTHS = {"gqa": (2, 128), "mla": (576,)}
DTYPES = {"f32": (np.float32, torch.float32, jnp.float32),
          "bf16": (ml_dtypes.bfloat16, torch.bfloat16, jnp.bfloat16)}


def _rows(seed, feat, np_dtype, b=3, s=17):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, s, *feat).astype(np.float32) * \
        np.exp(rng.randn(b, s, *([1] * len(feat)))).astype(np.float32)
    x[0, 0] = 0.0                               # an all-zero row: eps floor
    return x.astype(np_dtype)


def _torch(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("name", ["int8", "int4"])
def test_quantize_rows_bitwise_equals_reference_eager(name, width, dt):
    np_dt, t_dt, j_dt = DTYPES[dt]
    rows = _rows(1, WIDTHS[width], np_dt)
    jq, js = jpf.get_format(name).quantize_rows(jnp.asarray(rows))
    tq, ts = tpf.get_format(name).quantize_rows(_torch(rows))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # dequantized to the rows' own type, as the read paths do
    jd = jpf.get_format(name).dequantize(jq, js, j_dt)
    td = tpf.get_format(name).dequantize(tq, ts, t_dt)
    np.testing.assert_array_equal(td.float().numpy(),
                                  np.asarray(jd).astype(np.float32))


def test_int4_latent_row_is_strided_across_the_split_at_r():
    r, dr = 512, 64
    rows = _rows(2, (r + dr,), np.float32)
    q, s = tpf.INT4.quantize_rows(_torch(rows))
    assert q.shape[-1] == (r + dr) // 2
    ints = torch.round(_torch(rows) / s[..., None]).clamp(-8, 7)
    b = q.view(torch.uint8).to(torch.int32)
    lo = ((b & 15) + 8) % 16 - 8
    hi = (((b >> 4) & 15) + 8) % 16 - 8
    half = (r + dr) // 2                                   # 288
    assert torch.equal(lo, ints[..., :half].to(torch.int32))
    assert torch.equal(hi, ints[..., half:].to(torch.int32))
    # k_rope (elements 512-575) is the high nibbles of bytes 224-287
    assert torch.equal(hi[..., r - half:], ints[..., r:].to(torch.int32))
    assert torch.equal(unpack(q, 4, axis=-1).to(torch.int32),
                       ints.to(torch.int32))


@pytest.mark.parametrize("name", ["int8", "int4"])
def test_jitted_reference_scales_differ_by_at_most_one_ulp(name):
    """XLA rewrites amax / qmax as amax * (1 / qmax) under jit: one f32
    ulp on some rows, which may move an integer by one step.  The port
    keeps the division (the eager reference's arithmetic)."""
    rows = _rows(3, (2, 128), np.float32, b=8, s=250)
    jq, js = jax.jit(jpf.get_format(name).quantize_rows)(jnp.asarray(rows))
    tq, ts = tpf.get_format(name).quantize_rows(_torch(rows))
    ulp = np.abs(ts.numpy().view(np.int32).astype(np.int64)
                 - np.asarray(js).view(np.int32).astype(np.int64))
    bits = tpf.get_format(name).bits
    steps = np.abs(unpack(tq, bits, axis=-1).numpy().astype(np.int32)
                   - unpack(_torch(np.asarray(jq)), bits,
                            axis=-1).numpy().astype(np.int32))
    assert ulp.max() <= 1, ulp.max()
    assert steps.max() <= 1, steps.max()


def test_formats_and_errors():
    assert tpf.KV_FORMATS == jpf.KV_FORMATS == ("fp", "int8", "int4")
    for name in tpf.KV_FORMATS:
        t, j = tpf.get_format(name), jpf.get_format(name)
        assert (t.name, t.bits, t.pack, t.quantized) == \
            (j.name, j.bits, j.pack, j.quantized)
    with pytest.raises(ValueError, match=r"unknown kv_format 'int2'.*"
                       r"\('fp', 'int8', 'int4'\)"):
        tpf.get_format("int2")
    with pytest.raises(ValueError, match="kv_format='int4' packs 2"):
        tpf.INT4.packed_feat(9)
    assert tpf.INT4.packed_feat(576) == 288 and \
        tpf.INT8.packed_feat(576) == 576
    assert tpf.format_for_packed(128, 128) is tpf.INT8
    assert tpf.format_for_packed(576, 288) is tpf.INT4
    with pytest.raises(ValueError, match="no page format"):
        tpf.format_for_packed(16, 5)


@pytest.mark.parametrize("name", ["fp", "int8", "int4"])
def test_cache_specs_equal_reference(name):
    for jax_spec, spec, cfg in ((jax_kv_spec, paged_kv_cache_spec, GQA),
                                (jax_mla_spec, paged_mla_cache_spec, MLA)):
        jc = JaxCfg(**cfg, dtype=jnp.float32)
        tc = ArchConfig(**cfg, dtype=torch.float32)
        want = jax_spec(jc, 8, 4, fmt=jpf.get_format(name))
        got = spec(tc, 8, 4, fmt=tpf.get_format(name))
        assert list(got) == list(want)
        for k in want:
            assert got[k].shape == want[k].shape
            jd = want[k].dtype
            td = got[k].dtype
            assert (jd is None and td is None) or \
                str(td).split(".")[-1] == jnp.dtype(jd).name, (k, jd, td)


@pytest.mark.parametrize("name", ["int8", "int4"])
@pytest.mark.parametrize("cfg", [GQA, MLA], ids=["gqa", "mla"])
def test_paged_cache_leaves_equal_reference(cfg, name):
    """Leaves, shapes and dtypes of the whole (layers, ...) cache; the
    format is read back from the cache's own leaves."""
    jc = JaxCfg(**cfg, dtype=jnp.float32)
    tc = ArchConfig(**cfg, dtype=torch.float32)
    want = jax_init_cache(jc, 2, 7, 4, kv_format=name)
    got = init_paged_cache(tc, 7, 4, kv_format=name, device="cpu")
    assert [{k: (v.shape, v.dtype.name) for k, v in s.items()}
            for s in want] == \
        [{k: (tuple(v.shape), str(v.dtype).split(".")[-1])
          for k, v in s.items()} for s in got]
    layer = {k: v[0] for k, v in got[0].items()}
    feat = (tc.head_dim if "k" in layer else
            tc.kv_lora_rank + tc.qk_rope_dim)
    assert cache_page_format(layer, feat) is tpf.get_format(name)
    fp = init_paged_cache(tc, 7, 4, device="cpu")[0]
    assert cache_page_format({k: v[0] for k, v in fp.items()}, feat) is None
