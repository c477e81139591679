"""Inputs and recorders shared by the vision parity tests (a helper, not
collected).

Both frameworks run the same network on the same numpy weights and
images.  The weights are drawn with numpy from a seed at scales that
keep the activations of order one through every stage: He scales
(std sqrt(2 / fan_in), depthwise sqrt(2 / 9)) for MobileNetV1, whose
reference init (depthwise 0.3, 1 / sqrt(fan_in)) shrinks them 1.5-3x a
stage until the logits vanish (a row max of ~1e-7 at base 8), and the
reference's own 1 / sqrt(fan_in) for ResNet-20, whose residual sums keep
them alive.  Batch-norm scales are 1 + 0.1 N(0, 1), biases 0.01 N(0, 1).

``run_reference`` and ``run_port`` record the activation integers of
every quantized matmul (the packed ``x_q`` and the row scales handed to
the integer matmul): the reference's through a ``jax.debug.callback``
in ``kernels/ref.py::mpq_matmul_ref`` (the oracle the reference runs
with ``use_kernel=False``), the port's at ``kernels/ops.py``'s call of
``mpq_matmul``.  ``integer_moves`` compares them layer by layer.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core.quant import QuantConfig as JaxQuant
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.models import vision as JV
from repro_torch.core.packing import unpack
from repro_torch.core.quant import QuantConfig
from repro_torch.kernels import ops as port_ops
from repro_torch.models import vision as V

# (mode, a_bits, w_bits); None is the float32 network
FORMATS = {"fp32": None, "a8w8": ("int", 8, 8), "a8w4": ("int", 8, 4),
           "a4w2": ("int", 4, 2), "wo_w4": ("wo", 8, 4)}
# the networks at test size: MobileNetV1 base 8 on 32 x 32 images,
# ResNet-20 base 8 on 16 x 16, batch 2, 10 classes
NETS = {
    "mobilenet": dict(specs=lambda: V.mobilenet_specs(base=8, n_classes=10),
                      img=32, he=True, jax=JV.mobilenet_apply,
                      port=V.mobilenet_apply, layers=15),
    "resnet": dict(specs=lambda: V.resnet20_specs(base=8, n_classes=10),
                   img=16, he=False, jax=JV.resnet20_apply,
                   port=V.resnet20_apply, layers=22),
}
BATCH = 2
# the logits' tolerance, as a share of each row's largest |logit|
REL_TOL = 1e-5
# an activation integer may move by one step where a float32 sum (the
# depthwise conv, the mean pool) runs in another order across the two
# frameworks and crosses a rounding boundary; at most this share of a
# layer's integers may move (none moved on an x86 CPU host)
MAX_MOVED_SHARE = 1e-3
# the logits' tolerance where some integer moved, as a share of the row
# max: one step of a 4-bit activation is 1/7 of its row's largest value
MOVED_REL_TOL = 5e-2


def jax_quant(fmt):
    f = FORMATS[fmt]
    return None if f is None else JaxQuant(mode=f[0], a_bits=f[1],
                                           w_bits=f[2], use_kernel=False)


def port_quant(fmt):
    f = FORMATS[fmt]
    return None if f is None else QuantConfig(mode=f[0], a_bits=f[1],
                                              w_bits=f[2])


def weights(specs: dict, seed: int, he: bool) -> dict:
    rng = np.random.RandomState(seed)
    out = {}
    for k, s in specs.items():
        if s.init == "ones":
            v = 1 + 0.1 * rng.randn(*s.shape)
        elif s.init == "zeros":
            v = 0.01 * rng.randn(*s.shape)
        else:
            fan_in = 9 if k.startswith("dw") else int(np.prod(s.shape[:-1]))
            gain = 2.0 if he and k != "head" else 1.0
            v = np.sqrt(gain / fan_in) * rng.randn(*s.shape)
        out[k] = v.astype(np.float32)
    return out


def inputs(net: str, seed: int = 0):
    """(numpy weights, numpy images (B, H, W, 3)) of ``net``."""
    n = NETS[net]
    w = weights(n["specs"](), seed, n["he"])
    x = np.random.RandomState(seed + 1).randn(
        BATCH, n["img"], n["img"], 3).astype(np.float32)
    return w, x


def run_reference(net: str, w: dict, x: np.ndarray, fmt: str,
                  eager: bool = False):
    """The JAX network's logits and its activation integers per quantized
    layer, [(packed x_q, x_scale)], on raw weights with the oracle
    matmul; ``eager`` runs it under ``jax.disable_jit()``."""
    rec = []
    orig = jax_ref.mpq_matmul_ref

    def spy(x_q, x_scale, *a, **k):
        jax.debug.callback(
            lambda q, s: rec.append((np.asarray(q), np.asarray(s))), x_q,
            x_scale, ordered=True)
        return orig(x_q, x_scale, *a, **k)

    # a cached trace of the jitted matmul would skip the spy
    jax_ref.mpq_matmul_ref = spy
    jax_ops.quantized_matmul.clear_cache()
    try:
        with jax.disable_jit() if eager else contextlib.nullcontext():
            p = {k: jnp.asarray(v) for k, v in w.items()}
            y = np.asarray(NETS[net]["jax"](p, jnp.asarray(x),
                                            jax_quant(fmt)))
        jax.effects_barrier()
    finally:
        jax_ref.mpq_matmul_ref = orig
        jax_ops.quantized_matmul.clear_cache()
    return y, rec


@contextlib.contextmanager
def port_recorder():
    """Record the port's (packed x_q, x_scale) of every integer matmul."""
    rec = []
    orig = port_ops.mpq_matmul

    def spy(x_q, x_scale, *a, **k):
        rec.append((x_q.clone(), x_scale.clone()))
        return orig(x_q, x_scale, *a, **k)

    port_ops.mpq_matmul = spy
    try:
        yield rec
    finally:
        port_ops.mpq_matmul = orig


def run_port(net: str, params: dict, x: np.ndarray, fmt: str):
    with port_recorder() as rec:
        y = NETS[net]["port"](params, torch.from_numpy(x), port_quant(fmt))
    return y.numpy(), rec


def integer_moves(ref_rec, port_rec, a_bits: int):
    """Per quantized layer: (integers moved, largest step, integers)."""
    out = []
    for (jq, _), (tq, _) in zip(ref_rec, port_rec):
        a = unpack(torch.from_numpy(np.array(jq)), a_bits, axis=1).int()
        b = unpack(tq, a_bits, axis=1).int()
        d = (a - b).abs()
        out.append((int((d > 0).sum()), int(d.max()), d.numel()))
    return out


def moves(r: dict, fmt: str):
    """``integer_moves`` of a ``compare`` result ([] in a float format)."""
    f = FORMATS[fmt]
    if f is None or f[0] != "int":
        return []
    return integer_moves(r["jrec"], r["trec"], f[1])


def check_moves(per_layer) -> None:
    """Each moved integer moved one step, and few moved in each layer."""
    for i, (moved, step, n) in enumerate(per_layer):
        assert step <= 1, (i, per_layer)
        assert moved <= MAX_MOVED_SHARE * n, (i, per_layer)


def logit_tol(r: dict, fmt: str) -> float:
    """REL_TOL where every activation integer equals the reference's,
    MOVED_REL_TOL where one moved."""
    return MOVED_REL_TOL if any(m[0] for m in moves(r, fmt)) else REL_TOL


def row_err(got: np.ndarray, want: np.ndarray) -> float:
    """Largest |got - want| of each row over its largest |want|."""
    return float((np.abs(got - want).max(axis=1)
                  / np.abs(want).max(axis=1)).max())


def pack_params(specs: dict, params: dict, quant: QuantConfig) -> dict:
    """Every quantize-eligible weight as a PackedWeight of its flattened
    (kh * kw * cin, cout) form; the other leaves as they are."""
    return {k: port_ops.prepare_weight(v.reshape(-1, v.shape[-1]), quant)
            if specs[k].quantize else v for k, v in params.items()}


def compare(net: str, fmt: str, eager: bool = False, seed: int = 0) -> dict:
    """Both networks on the same weights and images: logits, the integer
    records, and the port's forward on PackedWeight leaves."""
    w, x = inputs(net, seed)
    jy, jrec = run_reference(net, w, x, fmt, eager)
    params = {k: torch.from_numpy(v) for k, v in w.items()}
    ty, trec = run_port(net, params, x, fmt)
    out = {"jax": jy, "port": ty, "jrec": jrec, "trec": trec}
    q = port_quant(fmt)
    if q is not None:
        packed = pack_params(NETS[net]["specs"](), params, q)
        out["packed"] = NETS[net]["port"](packed, torch.from_numpy(x),
                                          q).numpy()
    return out
