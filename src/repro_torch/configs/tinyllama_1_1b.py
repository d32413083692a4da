"""TinyLlama-1.1B [arXiv:2401.02385]: llama2-arch small, GQA 32H/4KV."""
from repro_torch.configs.base import ArchConfig, register

TINYLLAMA_1_1B = register(ArchConfig(
    name="tinyllama-1.1b",
    family="dense",
    num_layers=22,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    d_ff=5632,
    vocab_size=32000,
))
