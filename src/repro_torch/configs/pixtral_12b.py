"""Pixtral-12B [hf:mistralai/Pixtral-12B-2409]: mistral-nemo-style decoder
backbone; the pixtral-ViT frontend is a stub (input_specs() provides
precomputed patch embeddings)."""
from repro_torch.configs.base import ArchConfig, register

PIXTRAL_12B = register(ArchConfig(
    name="pixtral-12b",
    family="vlm",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    frontend="vision_stub",
    rope_theta=1_000_000.0,
))
