"""qwen1.5-4b [dense]: 40L d2560 20H (kv=20, MHA) d_ff=6912, QKV bias.

[hf:Qwen/Qwen1.5-0.5B; hf]

Data, copied from ``repro/configs/qwen15_4b.py``.
"""

from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-4b",
        family="dense",
        num_layers=40,
        d_model=2560,
        num_heads=20,
        num_kv_heads=20,
        head_dim=128,
        d_ff=6912,
        vocab_size=151936,
        attn_bias=True,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-4b-reduced",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        attn_bias=True,
        dtype="float32",
    )
