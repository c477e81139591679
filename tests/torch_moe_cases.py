"""Configs and weights shared by the port's MoE tests (a helper, not
collected): float32 (jax config, port config) pairs of the ``moe`` family
config of ``tests/test_continuous_batching.py::FAMILY_CFGS`` and of
reduced granite-moe-1b-a400m, optionally at another capacity factor, the
reference's init as numpy arrays, and the ``moe_ffn`` unit case (shapes,
chunk masks, capacity factors and planted ties)."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce
from repro.models import ArchConfig as JaxCfg
from repro.models import init_params as jax_init_params
from repro_torch.configs import get_config, reduce_config
from repro_torch.models.config import ArchConfig

GRANITE = "granite-moe-1b-a400m"
# FAMILY_CFGS["moe"], field for field
MOE = dict(name="cb_moe", family="moe", n_layers=2, d_model=64, n_heads=4,
           n_kv_heads=2, d_ff=0, vocab_size=100, n_experts=4, top_k=2,
           d_ff_expert=64, capacity_factor=8.0, decode_margin=32)


def configs(name, factor=None, f32=True):
    """(jax config, port config) of "moe" or the reduced granite,
    float32 unless ``f32`` is False, at capacity ``factor`` if given."""
    if name == "moe":
        jc = JaxCfg(**MOE, dtype=jnp.float32)
        tc = ArchConfig(**MOE, dtype=torch.float32)
    else:
        jc = jax_reduce(jax_get_config(GRANITE))
        tc = reduce_config(get_config(GRANITE))
        if f32:
            jc, tc = jc.with_(dtype=jnp.float32), tc.with_(
                dtype=torch.float32)
    if factor is not None:
        jc, tc = jc.with_(capacity_factor=factor), tc.with_(
            capacity_factor=factor)
    return jc, tc


def numpy_tree(jc, seed=0):
    """The reference's init of ``jc`` as numpy arrays."""
    return jax.tree.map(np.asarray,
                        jax_init_params(jc, jax.random.PRNGKey(seed)))


# the moe_ffn unit case: B x S tokens of width D, E experts, top K,
# expert width F
B, S, D, E, K, F = 3, 20, 32, 8, 2, 16
# each chunk slot's valid length (None: no mask); "masked_row" leaves
# slot 2 wholly padding, as an inactive slot of a chunk dispatch
MASKS = {"none": None, "chunk": (20, 13, 5), "masked_row": (20, 7, 0)}
FACTORS = (8.0, 1.0, 0.5)
TIES = ("columns", "row")


def unit_inputs(ties, seed=0):
    """The unit case's float32 weights and tokens, with ``ties`` planted:
    two equal router columns, or tokens of zeros (all E tie)."""
    rng = np.random.RandomState(seed)
    p = {"router": rng.randn(D, E) * 0.3,
         "w_gate": rng.randn(E, D, F) / np.sqrt(D),
         "w_up": rng.randn(E, D, F) / np.sqrt(D),
         "w_down": rng.randn(E, F, D) / np.sqrt(F)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.randn(B, S, D).astype(np.float32)
    if ties == "columns":
        p["router"][:, 5] = p["router"][:, 2]   # experts 2 and 5 tie
    else:
        x[0, 2] = x[1, 3] = x[2, 4] = x[0, 11] = 0.0   # all E tie
    return p, x
