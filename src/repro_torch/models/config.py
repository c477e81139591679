"""ArchConfig: one dataclass describing every architecture of the zoo.

The counterpart of ``repro.models.config`` with torch dtypes.  ``pattern``
is the block program: ``("scan", kind, count)`` is ``count`` identical
blocks, ``("group", ((kind, count), ...), repeats)`` the inner blocks in
order, ``repeats`` times.  The port runs programs of ``attn_mlp``,
``mla_mlp``, ``attn_moe``, ``mla_moe``, ``mamba`` and ``shared_attn``
blocks (:mod:`repro_torch.models.model` rejects the xLSTM kinds); the
fields of the families it does not serve yet are kept so that the config
files and ``reduce_config`` read as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core.quant import QuantConfig


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: int = 0                # 0 -> d_model // n_heads
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm: str = "rms"                # rms | layer
    mlp_act: str = "silu_glu"        # silu_glu | gelu

    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01

    # MLA (deepseek)
    kv_lora_rank: int = 0
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128

    # SSM / recurrent
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 256
    conv_dim: int = 4

    # block program; () -> derived from family.
    pattern: Tuple = ()

    input_mode: str = "tokens"       # tokens | embeds (audio/vlm stubs)
    sub_quadratic: bool = False      # eligible for long_500k

    # packed-weight format of every quantize-eligible dense
    # (models.model.quantize_for_serving); None = the model's dtype
    quant: Optional[QuantConfig] = None
    dtype: torch.dtype = torch.bfloat16
    decode_margin: int = 4096        # extra KV capacity beyond prompt

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if not self.pattern:
            kind = {"moe": "attn_moe"}.get(self.family, "attn_mlp")
            object.__setattr__(self, "pattern",
                               (("scan", kind, self.n_layers),))

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab_size, 256)

    def n_blocks(self) -> int:
        total = 0
        for entry in self.pattern:
            if entry[0] == "scan":
                total += entry[2]
            else:
                total += sum(c for _, c in entry[1]) * entry[2]
        return total

    def with_(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)
