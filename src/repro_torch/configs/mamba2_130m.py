"""mamba2-130m [ssm]: 24L d768 attn-free, SSD, ssm_state=128.

[arXiv:2405.21060; unverified]

Data, copied from ``repro/configs/mamba2_130m.py``.
"""

from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-130m",
        family="ssm",
        num_layers=24,
        d_model=768,
        num_heads=0,
        num_kv_heads=0,
        head_dim=0,
        d_ff=0,
        vocab_size=50280,
        ssm_state=128,
        ssm_expand=2,
        ssm_headdim=64,
        ssm_ngroups=1,
        ssm_conv=4,
        ssm_chunk=64,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="mamba2-130m-reduced",
        family="ssm",
        num_layers=2,
        d_model=64,
        num_heads=0,
        num_kv_heads=0,
        head_dim=0,
        d_ff=0,
        vocab_size=256,
        ssm_state=16,
        ssm_expand=2,
        ssm_headdim=16,
        ssm_ngroups=1,
        ssm_conv=4,
        ssm_chunk=16,
        dtype="float32",
    )
