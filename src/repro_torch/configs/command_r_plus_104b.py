"""command-r-plus-104b [dense]: 64L d12288 96H (kv=8) d_ff=33792, no bias.

[hf:CohereForAI/c4ai-command-r-v01; unverified]
(Real model uses parallel attn+FFN blocks; sequential pre-norm here —
noted in DESIGN.md, shapes unchanged.)

Data, copied from ``repro/configs/command_r_plus_104b.py``.
"""

from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="command-r-plus-104b",
        family="dense",
        num_layers=64,
        d_model=12288,
        num_heads=96,
        num_kv_heads=8,
        head_dim=128,
        d_ff=33792,
        vocab_size=256000,
        rope_theta=75000000.0,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="command-r-plus-reduced",
        family="dense",
        num_layers=2,
        d_model=96,
        num_heads=6,
        num_kv_heads=2,
        head_dim=16,
        d_ff=256,
        vocab_size=256,
        dtype="float32",
    )
