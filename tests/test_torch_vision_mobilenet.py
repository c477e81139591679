"""The port's MobileNetV1 against the JAX package's, on the CPU.

Base 8, 32 x 32 images, batch 2 (``tests/torch_vision_cases.py``):
float32, the paper's 8b (a8w8) and 8b4b (a8w4) against the reference as
it runs, its quantized matmul jitted, and weight-only w4.  (a4w2 runs in
``test_torch_vision_mobilenet_a4.py``, against the reference under
``jax.disable_jit()``.)  The logits must be within 1e-5 of each row's
max and the argmax equal; in the integer formats every layer's
activation integers are compared with the reference's, and the forward
on PackedWeight leaves must give the raw forward's logits bit for bit.
"""
import numpy as np
import pytest

import torch_vision_cases as cases
from repro_torch.kernels import mpq_matmul as mm

NET = "mobilenet"
FMTS = ("fp32", "a8w8", "a8w4", "wo_w4")
INT_FMTS = ("a8w8", "a8w4")


@pytest.fixture(scope="module")
def runs():
    before = mm.launches
    out = {fmt: cases.compare(NET, fmt) for fmt in FMTS}
    assert mm.launches == before          # CPU: plain versions only
    return out


@pytest.mark.parametrize("fmt", INT_FMTS)
def test_activation_integers_match_reference(runs, fmt):
    r = runs[fmt]
    assert len(r["jrec"]) == len(r["trec"]) == cases.NETS[NET]["layers"]
    cases.check_moves(cases.moves(r, fmt))


@pytest.mark.parametrize("fmt", FMTS)
def test_logits_match_reference(runs, fmt):
    r = runs[fmt]
    assert r["port"].shape == r["jax"].shape == (cases.BATCH, 10)
    assert np.isfinite(r["port"]).all()
    assert cases.row_err(r["port"], r["jax"]) <= cases.logit_tol(r, fmt)


@pytest.mark.parametrize("fmt", FMTS)
def test_argmax_equals_reference(runs, fmt):
    r = runs[fmt]
    np.testing.assert_array_equal(r["port"].argmax(1), r["jax"].argmax(1))


@pytest.mark.parametrize("fmt", INT_FMTS + ("wo_w4",))
def test_packed_leaves_give_the_raw_forward(runs, fmt):
    np.testing.assert_array_equal(runs[fmt]["packed"], runs[fmt]["port"])
