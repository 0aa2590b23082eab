"""seamless-m4t-large-v2 [audio]: enc-dec 24L+24L d1024 16H d_ff=8192.

Backbone only — the speech frontend is a stub: ``input_specs()`` supplies
precomputed frame embeddings consumed directly by the encoder.

[arXiv:2308.11596; hf]

Data, copied from ``repro/configs/seamless_m4t_large_v2.py``.
"""

from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2",
        family="encdec",
        num_layers=24,
        enc_layers=24,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        head_dim=64,
        d_ff=8192,
        vocab_size=256206,
        frontend="audio",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-reduced",
        family="encdec",
        num_layers=2,
        enc_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        frontend="audio",
        dtype="float32",
    )
