"""zamba2-7b [hybrid]: 81 Mamba2 layers (d3584, ssm_state=64) + ONE shared
full-attention block (32H/32kv, d_ff=14336) applied every 6 layers.

[arXiv:2411.15242; unverified]

Data, copied from ``repro/configs/zamba2_7b.py``.
"""

from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b",
        family="hybrid",
        num_layers=81,
        d_model=3584,
        num_heads=32,
        num_kv_heads=32,
        head_dim=112,  # 3584 / 32
        d_ff=14336,
        vocab_size=32000,
        ssm_state=64,
        ssm_expand=2,
        ssm_headdim=64,
        ssm_ngroups=1,
        ssm_conv=4,
        ssm_chunk=64,
        shared_attn_every=6,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b-reduced",
        family="hybrid",
        num_layers=5,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        ssm_state=16,
        ssm_expand=2,
        ssm_headdim=16,
        ssm_ngroups=1,
        ssm_conv=4,
        ssm_chunk=8,
        shared_attn_every=2,
        dtype="float32",
    )
