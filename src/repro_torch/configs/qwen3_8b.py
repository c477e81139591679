"""qwen3-8b [dense] — qk_norm, GQA kv=8 [hf:Qwen/Qwen3-8B; hf].

36L, d_model=4096, 32 heads (kv=8, head_dim=128), d_ff=12288,
vocab 151936, rope theta 1e6.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=12288,
    vocab_size=151936,
    qk_norm=True, rope_theta=1e6,
)
