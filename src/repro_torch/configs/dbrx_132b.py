"""dbrx-132b [moe]: 40L d6144 48H (GQA kv=8) d_ff=10752/expert, 16e top-4.

[hf:databricks/dbrx-base; unverified]

Data, copied from ``repro/configs/dbrx_132b.py``.
"""

from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b",
        family="moe",
        num_layers=40,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        head_dim=128,
        d_ff=10752,
        vocab_size=100352,
        num_experts=16,
        top_k=4,
        rope_theta=500000.0,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b-reduced",
        family="moe",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=96,
        vocab_size=256,
        num_experts=4,
        top_k=2,
        dtype="float32",
    )
