"""deepseek-v2-lite-16b [moe] — MLA kv_lora=512, shared+routed top-6
[arXiv:2405.04434; hf].

27L, d_model=2048, 16 MLA heads (kv_lora_rank=512, nope 128 / rope 64 /
v 128), 64 routed experts top-6 + 2 shared experts, per-expert
d_ff=1408, first layer dense (d_ff=10944), vocab 102400.

``CONFIG`` is the published model: the reference's two-scan block
program, one ``mla_mlp`` block and then 26 ``mla_moe`` blocks, each with
the 2 shared experts beside the routed ones.  ``DENSE``
(``deepseek-v2-lite-dense``, an id of the port's own) keeps every
published width and runs the first layer's block, MLA attention with the
dense SwiGLU MLP, in all 27 layers.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=10944,
    vocab_size=102400,
    n_experts=64, top_k=6, n_shared_experts=2, d_ff_expert=1408,
    kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    pattern=(("scan", "mla_mlp", 1), ("scan", "mla_moe", 26)),
)

DENSE = CONFIG.with_(name="deepseek-v2-lite-dense", family="dense",
                     pattern=(("scan", "mla_mlp", 27),))
