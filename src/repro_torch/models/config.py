"""Model configuration shared by all assigned architectures (a copy of
``repro.models.config``: pure Python, so ``param_count`` agrees)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str              # dense | moe | vlm | hybrid | audio | ssm
    n_layers: int
    d_model: int
    n_heads: int             # 0 for attention-free (rwkv6)
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    mixer: str = "gqa"       # gqa | mla | hybrid | rwkv6
    mlp: str = "dense"       # dense | moe
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # MLA (MiniCPM3)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    rope_head_dim: int = 0   # decoupled-RoPE dims per head (MLA)
    # SSM / hybrid
    ssm_state: int = 0
    ssm_heads: int = 0
    window: int = 0          # sliding-window attention size (0 = full)
    # attention details
    qk_norm: bool = False
    rope: bool = True
    rope_theta: float = 10000.0
    # misc
    tie_embeddings: bool = True
    act: str = "silu"
    dtype: str = "bfloat16"
    frontend: str = "none"   # none | vision | audio  (stub embeddings)
    # attention chunking for sub-quadratic MEMORY during long prefill
    attn_chunk: int = 512
    # SSM chunked (mamba2-style) scan: 0 = the sequential scan,
    # N = process N timesteps per state update (turns the state
    # recurrence from memory-bound into matmuls)
    ssm_chunk: int = 0
    # int8 KV cache (per-token-per-head symmetric scales): halves decode
    # cache memory+bandwidth for the MHA archs (musicgen, phi-3-vision)
    # whose 32k caches exceed a single-pod HBM budget. Opt-in.
    kv_cache_int8: bool = False

    @property
    def attention_free(self) -> bool:
        return self.mixer == "rwkv6"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (SSM / hybrid-with-SWA / linear attn)."""
        return self.mixer in ("rwkv6", "hybrid")

    def param_count(self) -> int:
        """Analytic parameter count (exact for our layer definitions)."""
        d, ff, V, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        H, Hkv, dh = self.n_heads, self.n_kv_heads, self.d_head
        n = V * d                      # embedding (tied head)
        if not self.tie_embeddings:
            n += V * d
        per_layer = 2 * d              # two RMSNorm gains
        if self.mixer == "gqa":
            per_layer += d * H * dh + 2 * d * Hkv * dh + H * dh * d
            if self.qk_norm:
                per_layer += 2 * dh
        elif self.mixer == "mla":
            qr, kvr, dr = self.q_lora_rank, self.kv_lora_rank, self.rope_head_dim
            per_layer += d * qr + qr + qr * H * (dh + dr)          # q path
            per_layer += d * (kvr + dr) + kvr                      # kv down
            per_layer += kvr * H * (dh + dh)                       # k_nope + v
            per_layer += H * dh * d                                # out
        elif self.mixer == "hybrid":
            per_layer += d * H * dh + 2 * d * Hkv * dh + H * dh * d
            sh, sd, N = self.ssm_heads, self.d_head, self.ssm_state
            di = sh * sd
            per_layer += d * 2 * di + di * 2 + di * (2 * N) + di + di * d
            per_layer += 2 * d        # extra norms for branch fusion
        elif self.mixer == "rwkv6":
            sh, dh2 = self.ssm_heads, self.d_head
            di = sh * dh2
            per_layer += 6 * d * di // (di // d if di >= d else 1) if False else 0
            per_layer += 5 * d * di + di * d   # r,k,v,g,w projections + out
            per_layer += 6 * d + 2 * 32 * d    # token-shift lerps + lora
        if self.mlp == "dense":
            per_layer += 3 * d * ff            # gated MLP (w1, w3, w2)
        else:
            E = self.n_experts
            per_layer += d * E                 # router
            per_layer += E * 3 * d * ff        # per-expert gated MLP
        n += L * per_layer + d                 # final norm
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k of n_experts)."""
        if self.mlp != "moe":
            return self.param_count()
        d, ff, L = self.d_model, self.d_ff, self.n_layers
        inactive = L * (self.n_experts - self.top_k) * 3 * d * ff
        return self.param_count() - inactive
