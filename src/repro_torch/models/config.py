"""Model configuration covering all assigned architecture families.

Follows ``repro/models/config.py``, copied field for field: one dataclass
describes dense GQA transformers, MoE (incl. fine-grained + shared experts
and MLA attention), pure SSM (Mamba2/SSD), hybrid (Mamba2 + shared
attention blocks), encoder-decoder, and modality-stub (VLM / audio)
backbones.  Per-arch instances live in ``repro_torch.configs``.  The port
runs the dense family so far (``models/blocks.py:plan``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- attention ---------------------------------------------------------
    attn_bias: bool = False  # qwen1.5 uses QKV bias
    attn_softcap: float = 0.0  # gemma2 logit soft-capping
    final_softcap: float = 0.0  # gemma2 final-logit soft-capping
    sliding_window: int = 0  # local-attention window (0 = off)
    local_global_pattern: bool = False  # gemma2 alternating local/global
    rope_theta: float = 10000.0
    mrope_sections: Tuple[int, ...] = ()  # qwen2-vl M-RoPE (t, h, w) dims
    attn_chunk: int = 512  # flash-attention KV-chunk length

    # --- norms / activations -------------------------------------------------
    norm_eps: float = 1e-6
    post_norms: bool = False  # gemma2 post-attn/post-ffn RMSNorms
    act: str = "silu"  # silu | gelu
    embed_scale: bool = False  # gemma2 scales embeddings by sqrt(d)

    # --- MoE -----------------------------------------------------------------
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    first_dense_layers: int = 0  # deepseek: layer 0 uses a dense FFN
    d_ff_dense: int = 0  # width of that dense FFN
    capacity_factor: float = 1.25
    router: str = "topk"  # topk | lp (LP-balanced routing, core solver)
    router_groups: int = 8  # token groups for the LP router

    # --- MLA (deepseek) --------------------------------------------------------
    use_mla: bool = False
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # --- SSM (mamba2 / SSD) ----------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_ngroups: int = 1
    ssm_conv: int = 4
    ssm_chunk: int = 64

    # --- hybrid (zamba2) ----------------------------------------------------
    shared_attn_every: int = 0  # apply the shared attention block every k layers

    # --- encoder-decoder (seamless) -------------------------------------------
    enc_layers: int = 0

    # --- modality stub -----------------------------------------------------
    frontend: str = "none"  # none | vision | audio
    num_patches: int = 0  # VLM: prefix length of precomputed patch embeds

    # --- numerics ------------------------------------------------------------
    dtype: str = "bfloat16"  # activation/param dtype
    tie_embeddings: bool = True

    @property
    def padded_vocab(self) -> int:
        """Embedding rows padded to a multiple of 128, as the reference pads them.

        The reference pads odd vocabularies (seamless 256206, mamba2 50280)
        so that the vocabulary axis shards evenly; the port keeps the same
        table shapes so that weights move between the two unchanged.
        Padded rows are masked to -1e30 at unembed, so loss and sampling
        never see them.
        """
        return ((self.vocab_size + 127) // 128) * 128

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim if self.ssm_headdim else 0

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic context scaling: SSM and hybrid families."""
        return self.family in ("ssm", "hybrid")

    def validate(self) -> "ModelConfig":
        if self.family not in ("dense", "moe", "ssm", "hybrid", "encdec"):
            raise ValueError(f"bad family {self.family}")
        if self.family == "moe":
            assert self.num_experts > 0 and self.top_k > 0
        if self.family in ("ssm", "hybrid"):
            assert self.ssm_state > 0
            assert self.d_inner % self.ssm_headdim == 0
        if self.use_mla:
            assert self.kv_lora_rank > 0 and self.qk_rope_dim > 0
        if self.family == "encdec":
            assert self.enc_layers > 0
        return self

    def param_count(self) -> int:
        """Approximate parameter count (used for MODEL_FLOPS in rooflines)."""
        d = self.d_model
        embed = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        # attention
        if self.family not in ("ssm",):
            if self.use_mla:
                attn = (
                    d * (self.kv_lora_rank + self.qk_rope_dim)
                    + self.kv_lora_rank * self.num_heads * (self.qk_nope_dim + self.v_head_dim)
                    + d * self.num_heads * (self.qk_nope_dim + self.qk_rope_dim)
                    + self.num_heads * self.v_head_dim * d
                )
            else:
                attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        else:
            attn = 0
        # ffn
        if self.family == "moe":
            ffn = 3 * d * self.d_ff * self.num_experts
            ffn += 3 * d * self.d_ff * self.num_shared_experts
            ffn += d * self.num_experts  # router
        else:
            ffn = 3 * d * self.d_ff
        if self.family in ("ssm", "hybrid"):
            di, ns, nh = self.d_inner, self.ssm_state, self.ssm_heads
            conv_ch = di + 2 * self.ssm_ngroups * ns
            ssm = d * (2 * di + 2 * self.ssm_ngroups * ns + nh) + conv_ch * self.ssm_conv
            ssm += di * d + di + 3 * nh
        else:
            ssm = 0
        if self.family == "dense" or self.family == "encdec":
            per_layer = attn + ffn
        elif self.family == "moe":
            per_layer = attn + ffn
        elif self.family == "ssm":
            per_layer = ssm
        elif self.family == "hybrid":
            per_layer = ssm
        total = embed + self.num_layers * per_layer
        if self.family == "hybrid" and self.shared_attn_every:
            shared = attn + 3 * d * self.d_ff
            total += shared  # one shared block
        if self.family == "encdec":
            total += self.enc_layers * (attn + ffn) + self.num_layers * attn  # cross-attn
        return total

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: only routed top-k + shared)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        full = self.param_count()
        all_experts = 3 * d * self.d_ff * self.num_experts * self.num_layers
        active_experts = 3 * d * self.d_ff * self.top_k * self.num_layers
        return full - all_experts + active_experts
