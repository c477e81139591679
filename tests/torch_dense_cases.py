"""Configs and weights shared by the port's qk_norm and dense-arch tests
(a helper, not collected): float32 (jax config, port config) pairs and
numpy weight trees whose ``q_norm`` / ``k_norm`` are drawn from a seed.

The reduced qwen3-8b and yi-34b have H 4 / KV 4 (G 1), so two configs
built from the same fields in both packages add the group sizes the full
configs serve: G 4 (qwen3-8b: H 32 / KV 8) and G 7 (yi-34b: H 56 / KV 8),
both with qk_norm.
"""
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

G4 = dict(name="qkn_g4", family="dense", n_layers=2, d_model=128, n_heads=8,
          n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=100, qk_norm=True,
          rope_theta=1e6, decode_margin=32)
G7 = dict(name="qkn_g7", family="dense", n_layers=2, d_model=112, n_heads=7,
          n_kv_heads=1, head_dim=16, d_ff=128, vocab_size=100, qk_norm=True,
          rope_theta=1e6, decode_margin=32)
# spread of the drawn norm weights: exp(NORM_SPREAD * N(0, 1)).  The
# init leaves them at ones, where a swap of the two or the norm applied
# after RoPE would change nothing
NORM_SPREAD = 0.5


def configs(name, f32=True):
    """(jax config, port config) of a reduced arch id, or of "g4" / "g7";
    float32 unless ``f32`` is False (the reduced archs then stay bf16)."""
    if name in ("g4", "g7"):
        fields = G4 if name == "g4" else G7
        return (JaxCfg(**fields, dtype=jnp.float32),
                ArchConfig(**fields, dtype=torch.float32))
    jc, tc = jax_reduce(jax_get_config(name)), reduce_config(get_config(name))
    if f32:
        jc, tc = jc.with_(dtype=jnp.float32), tc.with_(dtype=torch.float32)
    return jc, tc


def numpy_tree(jc, seed=0):
    """The reference's init as numpy arrays, with the stacked (L, dh)
    ``q_norm`` / ``k_norm`` leaves (where the config has them) redrawn
    from ``seed`` in their own dtype."""
    tree = jax.tree.map(np.asarray,
                        jax_init_params(jc, jax.random.PRNGKey(seed)))
    attn = tree["stages"][0]["attn"]
    rng = np.random.RandomState(seed + 100)
    for k in ("q_norm", "k_norm"):
        if k in attn:
            attn[k] = np.exp(NORM_SPREAD * rng.randn(*attn[k].shape)) \
                .astype(attn[k].dtype)
    return tree
