"""deepseek-v2-lite-16b [moe]: 27L d2048, MLA kv_lora=512, 2 shared + 64
routed top-6 fine-grained experts (d_ff=1408/expert), layer 0 dense.

[arXiv:2405.04434; hf]  (assignment header lists 64e; the '160 routed'
aside matches V2-full — we follow the 64-expert header, see DESIGN.md)

Data, copied from ``repro/configs/deepseek_v2_lite_16b.py``.
"""

from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-16b",
        family="moe",
        num_layers=27,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        head_dim=192,  # qk_nope + qk_rope
        d_ff=1408,
        vocab_size=102400,
        num_experts=64,
        num_shared_experts=2,
        top_k=6,
        first_dense_layers=1,
        d_ff_dense=10944,
        use_mla=True,
        kv_lora_rank=512,
        qk_nope_dim=128,
        qk_rope_dim=64,
        v_head_dim=128,
        rope_theta=10000.0,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-reduced",
        family="moe",
        num_layers=3,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=24,
        d_ff=32,
        vocab_size=256,
        num_experts=8,
        num_shared_experts=1,
        top_k=2,
        first_dense_layers=1,
        d_ff_dense=128,
        use_mla=True,
        kv_lora_rank=32,
        qk_nope_dim=16,
        qk_rope_dim=8,
        v_head_dim=16,
        dtype="float32",
    )
