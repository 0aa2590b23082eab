"""internlm2-20b [dense]: 48L d6144 48H (GQA kv=8) d_ff=16384.

[arXiv:2403.17297; hf]

Data, copied from ``repro/configs/internlm2_20b.py``.
"""

from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internlm2-20b",
        family="dense",
        num_layers=48,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        head_dim=128,
        d_ff=16384,
        vocab_size=92544,
        rope_theta=1000000.0,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="internlm2-20b-reduced",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        dtype="float32",
    )
