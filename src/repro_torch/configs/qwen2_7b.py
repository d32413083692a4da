"""Qwen2-7B [arXiv:2407.10671]: GQA (28H/4KV), QKV bias, SwiGLU."""
from repro_torch.configs.base import ArchConfig, register

QWEN2_7B = register(ArchConfig(
    name="qwen2-7b",
    family="dense",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    attn_bias=True,
    rope_theta=1_000_000.0,
))
