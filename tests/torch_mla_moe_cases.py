"""Configs and weights shared by the port's tests of two-scan block programs
and ``mla_moe`` blocks (a helper, not collected): float32 (jax config,
port config) pairs of reduced deepseek-v2-lite-16b (``mla_mlp`` x 1 +
``mla_moe`` x 2, 8 experts top-2, 2 shared experts) at capacity factors
4.0 and 0.5, and of a GQA two-scan program (``attn_mlp`` x 1 +
``attn_moe`` x 2, no shared experts); the reference's init as numpy
arrays, and the ``moe_ffn`` unit case with shared experts."""
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

DEEPSEEK = "deepseek-v2-lite-16b"
# a GQA program of two scans: a dense block, then two MoE blocks
TWO_SCAN = dict(name="two_scan", family="moe", n_layers=3, d_model=64,
                n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=100,
                n_experts=4, top_k=2, d_ff_expert=32, capacity_factor=8.0,
                decode_margin=32,
                pattern=(("scan", "attn_mlp", 1), ("scan", "attn_moe", 2)))
# the cases: "deepseek" (factor 4.0, reduce_config's), "deepseek-0.5"
# (chunks drop assignments) and "two_scan"
CASES = ("deepseek", "deepseek-0.5", "two_scan")


def configs(case, f32=True):
    """(jax config, port config) of ``case``; float32 unless ``f32`` is
    False (the reduced deepseek only)."""
    name, _, factor = case.partition("-")
    if name == "two_scan":
        return (JaxCfg(**TWO_SCAN, dtype=jnp.float32),
                ArchConfig(**TWO_SCAN, dtype=torch.float32))
    jc = jax_reduce(jax_get_config(DEEPSEEK))
    tc = reduce_config(get_config(DEEPSEEK))
    if f32:
        jc, tc = jc.with_(dtype=jnp.float32), tc.with_(dtype=torch.float32)
    if factor:
        jc, tc = (jc.with_(capacity_factor=float(factor)),
                  tc.with_(capacity_factor=float(factor)))
    return jc, tc


def config_fields(case):
    """The port config of ``case`` as ArchConfig keyword arguments (for
    ``tests/torch_swap_lockstep.py``, which builds both configs from
    one dict)."""
    _, tc = configs(case)
    fields = {f: getattr(tc, f) for f in (
        "name", "family", "n_layers", "d_model", "n_heads", "n_kv_heads",
        "head_dim", "d_ff", "vocab_size", "n_experts", "top_k",
        "n_shared_experts", "d_ff_expert", "capacity_factor",
        "kv_lora_rank", "qk_nope_dim", "qk_rope_dim", "v_head_dim",
        "pattern", "decode_margin")}
    fields["name"] = f"{tc.name}_{case}"
    return fields


def numpy_tree(jc, seed=0):
    """The reference's init of ``jc`` as numpy arrays."""
    return jax.tree.map(np.asarray,
                        jax_init_params(jc, jax.random.PRNGKey(seed)))


# the moe_ffn unit case: B x S tokens of width D, E experts, top K,
# expert width F, N_SHARED shared experts of width F each
B, S, D, E, K, F, N_SHARED = 3, 20, 32, 8, 2, 16, 2
MASKS = {"none": None, "chunk": (20, 13, 5), "masked_row": (20, 7, 0)}
FACTORS = (8.0, 0.5)
TIES = ("columns", "row")


def unit_inputs(ties, seed=0):
    """The unit case's float32 weights (the shared experts' subtree
    included) and tokens, with ``ties`` planted: two equal router
    columns, or tokens of zeros (all E tie)."""
    rng = np.random.RandomState(seed)
    fs = F * N_SHARED
    p = {"router": rng.randn(D, E) * 0.3,
         "w_gate": rng.randn(E, D, F) / np.sqrt(D),
         "w_up": rng.randn(E, D, F) / np.sqrt(D),
         "w_down": rng.randn(E, F, D) / np.sqrt(F),
         "shared": {"w_gate": rng.randn(D, fs) / np.sqrt(D),
                    "w_up": rng.randn(D, fs) / np.sqrt(D),
                    "w_down": rng.randn(fs, D) / np.sqrt(fs)}}
    p = jax.tree.map(lambda a: a.astype(np.float32), p)
    x = rng.randn(B, S, D).astype(np.float32)
    if ties == "columns":
        p["router"][:, 5] = p["router"][:, 2]   # experts 2 and 5 tie
    else:
        x[0, 2] = x[1, 3] = x[2, 4] = x[0, 11] = 0.0   # all E tie
    return p, x
