"""Config registry: ``--arch <id>`` resolution, input shapes, reduction.

The counterpart of ``repro.configs``.  The port carries the arch files
of the dense, MLA, MoE and hybrid paths it serves: qwen2.5-3b (GQA with
QKV bias), qwen3-8b (GQA with qk_norm), yi-34b (llama-style GQA),
stablelm-3b (LayerNorm and MHA), granite-moe-1b-a400m (GQA and a top-8
MoE FFN in every block), deepseek-v2-lite-16b (MLA: an ``mla_mlp`` block,
then 26 ``mla_moe`` blocks with shared experts) and zamba2-7b (13 groups
of 5 Mamba2 blocks and the shared attention block, then 3 Mamba2
blocks).  The reference's other three ids (xlstm-350m, chameleon-34b,
musicgen-medium) follow with their families (ROADMAP queue 1 item 13).
Every id is the reference's but one: ``deepseek-v2-lite-dense``,
deepseek-v2-lite's widths with its dense MLA block in every layer
(``configs/deepseek_v2_lite.py::DENSE``),
which the MLA serving checks use.  It is the only port-only id: an
``--arch`` the port accepts is the reference's or this one.
``reduce_config`` shrinks a config to a CPU-testable size
while keeping its block structure, exactly as the reference does.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict

from repro_torch.models.config import ArchConfig

# arch id -> (module, attribute)
_MODULES = {
    "qwen2.5-3b": ("qwen2_5_3b", "CONFIG"),
    "qwen3-8b": ("qwen3_8b", "CONFIG"),
    "yi-34b": ("yi_34b", "CONFIG"),
    "stablelm-3b": ("stablelm_3b", "CONFIG"),
    "granite-moe-1b-a400m": ("granite_moe_1b", "CONFIG"),
    "deepseek-v2-lite-16b": ("deepseek_v2_lite", "CONFIG"),
    "deepseek-v2-lite-dense": ("deepseek_v2_lite", "DENSE"),
    "zamba2-7b": ("zamba2_7b", "CONFIG"),
}


def get_config(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    module, attr = _MODULES[name]
    mod = importlib.import_module(f"repro_torch.configs.{module}")
    return getattr(mod, attr)


def all_archs():
    return list(_MODULES)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    step: str            # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def reduce_config(cfg: ArchConfig) -> ArchConfig:
    """Reduced same-family config for CPU smoke tests."""
    pattern = []
    for entry in cfg.pattern:
        if entry[0] == "scan":
            pattern.append(("scan", entry[1], min(entry[2], 2)))
        else:
            group = tuple((k, min(c, 2)) for k, c in entry[1])
            pattern.append(("group", group, min(entry[2], 2)))
    heads = min(cfg.n_heads, 4)
    kv = min(cfg.n_kv_heads, heads)
    kw = dict(
        n_layers=sum(e[2] if e[0] == "scan"
                     else sum(c for _, c in e[1]) * e[2] for e in pattern),
        d_model=128, n_heads=heads, n_kv_heads=kv, head_dim=128 // heads,
        d_ff=min(cfg.d_ff, 256) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512),
        pattern=tuple(pattern),
        ssm_chunk=8,
    )
    if cfg.n_experts:
        kw.update(n_experts=min(cfg.n_experts, 8),
                  top_k=min(cfg.top_k, 2),
                  d_ff_expert=min(cfg.d_ff_expert, 64),
                  capacity_factor=4.0)
    if cfg.kv_lora_rank:
        kw.update(kv_lora_rank=64, qk_nope_dim=32, qk_rope_dim=16,
                  v_head_dim=32)
    if cfg.ssm_state:
        kw.update(ssm_state=16, ssm_headdim=16)
    if cfg.family == "ssm":   # xlstm: heads divide d_model
        kw.update(n_heads=4, n_kv_heads=4, head_dim=32)
    kw["decode_margin"] = 32
    return cfg.with_(**kw)
