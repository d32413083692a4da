"""Qwen1.5-0.5B [hf:Qwen/Qwen1.5-0.5B]: MHA (16H/16KV), QKV bias."""
from repro_torch.configs.base import ArchConfig, register

QWEN1_5_0_5B = register(ArchConfig(
    name="qwen1.5-0.5b",
    family="dense",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=2816,
    vocab_size=151936,
    attn_bias=True,
))
