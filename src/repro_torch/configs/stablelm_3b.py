"""stablelm-3b [dense] — [hf:stabilityai/stablelm family; unverified].

32L, d_model=2560, 32 MHA heads (kv=32), d_ff=6912, vocab 50304,
LayerNorm (stablelm-2 style).
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-3b", family="dense",
    n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32, d_ff=6912,
    vocab_size=50304,
    norm="layer",
)
