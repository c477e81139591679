"""zamba2-7b [hybrid] — Mamba2 backbone + shared attention blocks
[arXiv:2411.15242; unverified].

81 blocks, d_model=3584, ssm_state=64 (headdim 64 -> 112 SSM heads);
one SHARED full attention+MLP block (32 MHA heads, d_ff=14336) applied
every 6th position: 13 periods of [5 x mamba2, 1 x shared_attn] + 3
trailing mamba2 = 81.  The shared block's parameters are held once
(weight sharing, as in Zamba2).
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, d_ff=14336,
    vocab_size=32000,
    ssm_state=64, ssm_headdim=64, ssm_expand=2, ssm_chunk=256,
    pattern=(("group", (("mamba", 5), ("shared_attn", 1)), 13),
             ("scan", "mamba", 3)),
    sub_quadratic=True,
)
