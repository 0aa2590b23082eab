"""gemma2-2b [dense]: 26L d2304 8H (kv=4, head_dim 256) d_ff=9216,
local(4096)/global alternating, attn softcap 50, final softcap 30, GeGLU,
post-norms, scaled embeddings.

[arXiv:2408.00118; hf]

Data, copied from ``repro/configs/gemma2_2b.py``.
"""

from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-2b",
        family="dense",
        num_layers=26,
        d_model=2304,
        num_heads=8,
        num_kv_heads=4,
        head_dim=256,
        d_ff=9216,
        vocab_size=256000,
        attn_softcap=50.0,
        final_softcap=30.0,
        sliding_window=4096,
        local_global_pattern=True,
        post_norms=True,
        act="gelu",
        embed_scale=True,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="gemma2-2b-reduced",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=32,
        d_ff=128,
        vocab_size=256,
        attn_softcap=50.0,
        final_softcap=30.0,
        sliding_window=16,
        local_global_pattern=True,
        post_norms=True,
        act="gelu",
        embed_scale=True,
        dtype="float32",
    )
