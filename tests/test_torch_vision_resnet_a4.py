"""The port's ResNet-20 at the paper's 4b2b (a4w2: 4-bit activations,
2-bit weights) against the JAX package's, on the CPU, with the reference
under ``jax.disable_jit()``.

Under ``jax.jit`` XLA computes an activation scale ``amax / 7`` one ulp
away from the division that eager JAX and the port compute (ROADMAP
queue 3), and at 4 bits such an ulp moves integers and, through the
network, the logits (by 0.76 at a row max of 5.2 on ResNet-20 base 8);
so the reference runs eagerly here.  Base 8, 16 x 16 images, batch 2
(``tests/torch_vision_cases.py``).  Every layer's activation integers
(22 quantized matmuls) are compared with the reference's, the logits
held within 1e-5 of each row's max, the argmax equal.
"""
import numpy as np
import pytest

import torch_vision_cases as cases

NET = "resnet"


@pytest.fixture(scope="module")
def run():
    return cases.compare(NET, "a4w2", eager=True)


def test_activation_integers_match_reference(run):
    assert len(run["jrec"]) == len(run["trec"]) == \
        cases.NETS[NET]["layers"]
    cases.check_moves(cases.moves(run, "a4w2"))


def test_activation_scales_match_reference(run):
    """Row scales agree to float32 rounding: the float sums before them
    (the depthwise conv, the mean pool) run in each framework's order."""
    for (_, js), (_, ts) in zip(run["jrec"], run["trec"]):
        np.testing.assert_allclose(ts.numpy(), js, rtol=1e-5, atol=0)


def test_logits_match_reference(run):
    assert np.isfinite(run["port"]).all()
    assert cases.row_err(run["port"], run["jax"]) <= \
        cases.logit_tol(run, "a4w2")


def test_argmax_equals_reference(run):
    np.testing.assert_array_equal(run["port"].argmax(1),
                                  run["jax"].argmax(1))


def test_packed_leaves_give_the_raw_forward(run):
    np.testing.assert_array_equal(run["packed"], run["port"])
