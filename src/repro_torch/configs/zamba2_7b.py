"""Zamba2-7B [arXiv:2411.15242]: Mamba2 backbone + one shared attention
block applied every 6 layers (weight-shared, MHA 32H)."""
from repro_torch.configs.base import ArchConfig, register

_PATTERN = tuple("shared_attn" if (i % 6) == 5 else "mamba"
                 for i in range(81))

ZAMBA2_7B = register(ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    block_pattern=_PATTERN,
    attn_every=6,
))
