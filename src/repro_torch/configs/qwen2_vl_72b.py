"""qwen2-vl-72b [vlm]: 80L d8192 64H (kv=8) d_ff=29568, M-RoPE.

Backbone only — the vision frontend is a stub: ``input_specs()`` supplies
precomputed patch embeddings merged at the sequence prefix.

[arXiv:2409.12191; hf]

Data, copied from ``repro/configs/qwen2_vl_72b.py``.
"""

from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-72b",
        family="dense",
        num_layers=80,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=29568,
        vocab_size=152064,
        attn_bias=True,
        mrope_sections=(16, 24, 24),
        frontend="vision",
        num_patches=256,
        rope_theta=1000000.0,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-72b-reduced",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=32,
        d_ff=128,
        vocab_size=256,
        attn_bias=True,
        mrope_sections=(4, 6, 6),
        frontend="vision",
        num_patches=8,
        dtype="float32",
    )
