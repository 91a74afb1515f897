"""Model configuration — one dataclass drives all ten assigned architectures."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int                     # 0 for attention-free archs
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 → d_model // n_heads
    qkv_bias: bool = False
    qk_norm: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-5

    # MoE
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0                # per-expert hidden dim (defaults to d_ff)
    moe_period: int = 1              # MoE FFN every k-th layer (jamba: 2)
    moe_capacity_factor: float = 1.25

    # layer mixer pattern: 'attn' | 'mamba' | 'rwkv'; cycled over n_layers
    mixer_pattern: Tuple[str, ...] = ("attn",)

    # SSM (mamba) dims
    ssm_expand: int = 2
    ssm_state_dim: int = 16
    ssm_conv_dim: int = 4
    ssm_dt_rank: int = 0             # 0 → ceil(d_model/16)
    ssm_seq_chunks: int = 4          # python-unrolled outer segments for scan

    # RWKV6 dims
    rwkv_head_dim: int = 64
    rwkv_chunk: int = 32             # WKV6 chunk length
    rwkv_lora_r: int = 64            # decay/mix LoRA rank

    # modality frontend stub: model consumes precomputed (B, S, d_model)
    # embeddings instead of token ids (pixtral patches / musicgen frames)
    embedding_inputs: bool = False

    dtype: str = "bfloat16"
    remat: bool = True               # recompute each block in backward
    attn_q_chunk: int = 0            # q-chunked exact attention (0 = off)
    qmode: str = "none"              # serving quantization (CAMP)
    max_seq_len: int = 8192

    # -- derived ---------------------------------------------------------
    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def dt_rank(self) -> int:
        return self.ssm_dt_rank or -(-self.d_model // 16)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    def mixer_of(self, layer: int) -> str:
        return self.mixer_pattern[layer % len(self.mixer_pattern)]

    def ffn_of(self, layer: int) -> str:
        if self.moe_experts and (layer % self.moe_period == self.moe_period - 1):
            return "moe"
        if self.mixer_of(layer) == "rwkv":
            return "rwkv_cmix"
        return "dense"

    @property
    def expert_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    def param_count(self) -> int:
        """Analytic parameter count (embedding included once if tied)."""
        d, hd = self.d_model, self.hd
        total = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        for i in range(self.n_layers):
            mixer = self.mixer_of(i)
            if mixer == "attn":
                total += d * hd * (self.n_heads + 2 * self.n_kv_heads)  # qkv
                total += self.n_heads * hd * d                           # wo
                if self.qkv_bias:
                    total += hd * (self.n_heads + 2 * self.n_kv_heads)
            elif mixer == "mamba":
                di, N, r = self.d_inner, self.ssm_state_dim, self.dt_rank
                total += d * 2 * di + di * self.ssm_conv_dim
                total += di * (r + 2 * N) + r * di + di * N + 2 * di
                total += di * d
            elif mixer == "rwkv":
                total += 4 * d * d + d * d       # r,k,v,gate + out
                total += 2 * (d * self.rwkv_lora_r * 2)  # decay/mix LoRAs
            ffn = self.ffn_of(i)
            if ffn == "dense":
                total += 3 * d * self.d_ff
            elif ffn == "moe":
                total += d * self.moe_experts
                total += self.moe_experts * 3 * d * self.expert_ff
            elif ffn == "rwkv_cmix":
                total += 2 * d * self.d_ff // 2 + d * self.d_ff  # k,v,r
            total += 2 * d                       # norms
        total += d                               # final norm
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top-k experts only)."""
        if not self.moe_experts:
            return self.param_count()
        d = self.d_model
        dense_like = dataclasses.replace(self, moe_experts=0, moe_top_k=0)
        base = dense_like.param_count()
        # remove the dense FFNs that MoE layers replace, add k experts + router
        n_moe = sum(1 for i in range(self.n_layers) if self.ffn_of(i) == "moe")
        base -= n_moe * 3 * d * self.d_ff
        base += n_moe * (d * self.moe_experts
                         + self.moe_top_k * 3 * d * self.expert_ff)
        return base
