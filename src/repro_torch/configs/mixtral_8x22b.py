"""Mixtral-8x22B [arXiv:2401.04088]: 8 experts top-2, GQA 48H/8KV, SWA."""
from repro_torch.configs.base import ArchConfig, MoEConfig, register

MIXTRAL_8X22B = register(ArchConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=32768,
    sliding_window=4096,
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=16384),
    rope_theta=1_000_000.0,
))
