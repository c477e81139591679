"""granite-moe-1b-a400m [moe] — 32 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf].

24L, d_model=1024, 16 heads (kv=8), per-expert d_ff=512, vocab 49155
(padded to 49408 for sharding; loss masks the pad ids).
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8, d_ff=512,
    vocab_size=49155,
    n_experts=32, top_k=8, d_ff_expert=512,
)
