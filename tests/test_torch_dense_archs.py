"""The dense arch files qwen3-8b and yi-34b in the port, on the CPU.

  * the registry: both ids resolve to the reference's fields, and reduce
    alike;
  * the bridge: a bf16 tree with float32 ``q_norm`` / ``k_norm`` leaves
    crosses both ways bit for bit, each leaf keeping its dtype;
  * ``quantize_for_serving(..., consume=True)``, which frees each raw leaf
    once it is packed, gives the non-consuming form's packed tree and
    count bit for bit (and the reference's), at w4a16 and w8a8, and
    leaves the raw model empty;
  * the serving engine against the JAX engine on fp and int8 pools, on
    float32 reduced qwen3-8b and yi-34b (G 1) and on the G 4 and G 7
    qk_norm configs of ``tests/torch_dense_cases.py``, with the norm
    weights redrawn from a seed: tokens, completion order, counters and
    TTFT ticks equal, logits within ``atol=1e-5``;
  * the launcher serves both archs reduced.
"""
import contextlib
import dataclasses
import gc
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce
from repro.core.quant import QuantConfig as JaxQuant
from repro.kernels.ops import PackedWeight as JaxPacked
from repro.models.model import quantize_for_serving as jax_quantize
from repro.serve import Request as JaxRequest
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import ServingEngine as JaxEngine
from repro_torch.configs import all_archs, get_config, reduce_config
from repro_torch.core.quant import QuantConfig
from repro_torch.kernels.ops import PackedWeight
from repro_torch.launch import serve as launcher
from repro_torch.models.model import init_params, quantize_for_serving
from repro_torch.serve import Request, ServeConfig, ServingEngine
from repro_torch.models import model as tmodel
from repro_torch.weights import from_jax_numpy, to_jax_numpy
from torch_dense_cases import configs, numpy_tree

ARCHS = ("qwen3-8b", "yi-34b")
SERVE = dict(max_batch=3, max_prompt=8, max_new_tokens=6, page_size=4,
             max_seq=40, record_logits=True)
COUNTERS = ["n_cow_copies", "n_shared_admissions", "n_preemptions",
            "peak_active", "tick_no"]
QUANTS = {"w4a16": ("wo", 8, 4), "w8a8": ("int", 8, 8)}


def _fields(cfg, keys=None):
    """A config's fields (those in ``keys`` only, if given), the dtype by
    name (the two packages' dtype types differ)."""
    out = dataclasses.asdict(cfg)
    out["dtype"] = str(cfg.dtype).split(".")[-1].strip("'>")
    return {k: v for k, v in out.items() if keys is None or k in keys}


def _leaves_bitwise(want, got):
    la, ta = jax.tree.flatten(want)
    lb, tb = jax.tree.flatten(got)
    assert ta == tb
    for a, b in zip(la, lb):
        if isinstance(a, int):
            assert a == b
            continue
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def _packed_numpy(tree):
    def leaf(x):
        if isinstance(x, JaxPacked):
            return {"packed": np.asarray(x.packed),
                    "scale": np.asarray(x.scale), "k": x.k, "n": x.n,
                    "w_bits": x.w_bits}
        return np.asarray(x)
    return jax.tree.map(leaf, tree,
                        is_leaf=lambda x: isinstance(x, JaxPacked))


# -- registry -----------------------------------------------------------------

@pytest.mark.parametrize("name", ARCHS)
def test_registry_has_the_reference_fields(name):
    """Every field of the port's config equals the reference's; the
    reference's own extra (``remat``, a training knob) is the only one
    the port lacks."""
    assert name in all_archs()
    mine = _fields(get_config(name))
    assert set(_fields(jax_get_config(name))) - set(mine) == {"remat"}
    assert mine == _fields(jax_get_config(name), mine)
    assert _fields(reduce_config(get_config(name))) == \
        _fields(jax_reduce(jax_get_config(name)), mine)


def test_registered_widths():
    q, y = get_config("qwen3-8b"), get_config("yi-34b")
    assert (q.n_layers, q.d_model, q.n_heads, q.n_kv_heads, q.head_dim,
            q.d_ff, q.vocab_size, q.qk_norm) == \
        (36, 4096, 32, 8, 128, 12288, 151936, True)
    assert (y.n_layers, y.d_model, y.n_heads, y.n_kv_heads, y.head_dim,
            y.d_ff, y.vocab_size, y.qk_norm) == \
        (60, 7168, 56, 8, 128, 20480, 64000, False)


# -- the bridge ---------------------------------------------------------------

@pytest.mark.parametrize("name", ARCHS)
def test_bf16_bridge_round_trip_keeps_float32_norms(name):
    jc, tc = configs(name, f32=False)
    tree = numpy_tree(jc)
    model = from_jax_numpy(tc, tree, device="cpu")
    if tc.qk_norm:
        attn = model.blocks[0].attn
        assert attn["q_norm"].dtype == attn["k_norm"].dtype == torch.float32
        assert attn["wq"].dtype == torch.bfloat16
        assert tree["stages"][0]["attn"]["q_norm"].dtype == np.float32
    _leaves_bitwise(tree, to_jax_numpy(tc, model))


# -- consuming packing -------------------------------------------------------

@pytest.mark.parametrize("fmt", sorted(QUANTS))
@pytest.mark.parametrize("name", ARCHS)
def test_consuming_quantize_equals_the_copying_form(name, fmt):
    mode, a, w = QUANTS[fmt]
    jc = jax_reduce(jax_get_config(name)).with_(
        quant=JaxQuant(mode=mode, a_bits=a, w_bits=w, use_kernel=False))
    tc = reduce_config(get_config(name)).with_(
        quant=QuantConfig(mode=mode, a_bits=a, w_bits=w))
    tree = numpy_tree(jc)
    copied, n_copy = quantize_for_serving(
        tc, from_jax_numpy(tc, tree, device="cpu"))
    raw = from_jax_numpy(tc, tree, device="cpu")
    consumed, n_cons = quantize_for_serving(tc, raw, consume=True)
    jpacked, jn = jax_quantize(jc, jax.tree.map(jnp.asarray, tree))
    assert n_cons == n_copy == jn
    assert sum(isinstance(m, PackedWeight) for m in consumed.modules()) == \
        7 * tc.n_layers + 1
    _leaves_bitwise(to_jax_numpy(tc, copied), to_jax_numpy(tc, consumed))
    _leaves_bitwise(_packed_numpy(jpacked), to_jax_numpy(tc, consumed))
    # the raw model gave up every tensor
    assert all(p.numel() == 0 for p in raw.parameters())


def _key(t):
    return t.untyped_storage().data_ptr(), t.dtype, tuple(t.shape)


def _live(keys):
    """The raw leaves among ``keys`` (storage, dtype, shape) that a live
    tensor still holds (a packed tensor may reuse a freed address, in
    another dtype and shape)."""
    return {_key(o) for o in gc.get_objects()
            if isinstance(o, torch.Tensor) and o.numel()
            and _key(o) in keys}


@pytest.mark.parametrize("consume", [True, False])
def test_consuming_quantize_frees_each_raw_leaf_once_packed(consume,
                                                            monkeypatch):
    """Each time a leaf is packed, every raw leaf packed before it is
    already freed (no live tensor holds its storage) when the raw model
    is consumed; the copying form keeps them all alive."""
    tc = reduce_config(get_config("yi-34b")).with_(
        quant=QuantConfig(mode="wo", a_bits=8, w_bits=4))
    raw = init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    done, alive_at = [], []
    prepare = tmodel.prepare_weight

    def watched(w, quant):
        alive_at.append(_live(set(done)))
        done.append(_key(w))
        return prepare(w, quant)
    monkeypatch.setattr(tmodel, "prepare_weight", watched)
    packed, _ = quantize_for_serving(tc, raw, consume=consume)
    assert len(done) == 7 * tc.n_layers + 1
    if consume:
        assert all(not a for a in alive_at)
        assert not _live(set(done))
    else:
        assert [len(a) for a in alive_at] == list(range(len(done)))
    del packed


# -- the engine against the JAX engine ----------------------------------------

def _prompts(vocab):
    rng = np.random.RandomState(1)
    base = [int(t) for t in rng.randint(0, vocab, 18)]
    other = [[int(t) for t in rng.randint(0, vocab, n)]
             for n in (5, 3, 11, 19, 2, 14)]
    # the sharer (base + [9]) arrives once a short request has freed a
    # slot, while base + [7, 8] is resident and prefilled
    return [base + [7, 8], other[4], other[1], base + [9], other[0],
            other[2], other[3], other[5]]


@pytest.fixture(scope="module", params=[(n, f) for n in
                                        ("qwen3-8b", "yi-34b", "g4", "g7")
                                        for f in ("fp", "int8")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def engines(request):
    name, fmt = request.param
    jc, tc = configs(name)
    tree = numpy_tree(jc)
    prompts = _prompts(tc.vocab_size)
    je = JaxEngine(jc, jax.tree.map(jnp.asarray, tree),
                   JaxServeConfig(**SERVE, kv_format=fmt))
    jout = je.run([JaxRequest(i, p) for i, p in enumerate(prompts)])
    te = ServingEngine(tc, from_jax_numpy(tc, tree, device="cpu"),
                       ServeConfig(**SERVE, kv_format=fmt), device="cpu")
    tout = te.run([Request(i, p) for i, p in enumerate(prompts)])
    return {"jax": je, "port": te, "n": len(prompts),
            "jout": {r.rid: r for r in jout},
            "tout": {r.rid: r for r in tout}}


def test_tokens_equal_reference(engines):
    assert len(engines["tout"]) == engines["n"]
    for rid, ref in engines["jout"].items():
        got = engines["tout"][rid]
        assert got.done and not got.failed
        assert got.out_tokens == ref.out_tokens, rid


def test_completion_order_equals_reference(engines):
    assert [r.rid for r in engines["jax"].completed] == \
        [r.rid for r in engines["port"].completed]


@pytest.mark.parametrize("counter", COUNTERS)
def test_counters_equal_reference(engines, counter):
    assert getattr(engines["port"], counter) == \
        getattr(engines["jax"], counter)


def test_ttft_ticks_equal_reference(engines):
    for rid, ref in engines["jout"].items():
        assert engines["tout"][rid].ttft_ticks == ref.ttft_ticks, rid


def test_logits_match_reference(engines):
    for rid, ref in engines["jout"].items():
        got = engines["tout"][rid].logits
        assert len(got) == len(ref.logits)
        for a, b in zip(got, ref.logits):
            np.testing.assert_allclose(a, np.asarray(b), atol=1e-5, rtol=0)


def test_sharing_and_resumed_paths_exercised(engines):
    eng = engines["port"]
    assert eng.n_shared_admissions >= 1
    assert eng.pages_in_use() == 0
    assert eng.stats()["kernel_launches"] == 0  # CPU: plain versions only


# -- the launcher ------------------------------------------------------------

@pytest.mark.parametrize("name", ARCHS)
def test_launcher_serves_the_arch_reduced_on_cpu(name):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launcher.main(["--arch", name, "--reduce", "--device", "cpu",
                       "--requests", "3", "--max-batch", "2",
                       "--max-new-tokens", "4", "--quant", "w4a16"])
    lines = out.getvalue().splitlines()
    assert lines[0] == "serving with w4a16: packed 8 tensors"
    assert sum(ln.startswith("req ") and "[done" in ln for ln in lines) == 3
