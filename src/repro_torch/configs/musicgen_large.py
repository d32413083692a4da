"""MusicGen-large [arXiv:2306.05284]: decoder-only over EnCodec tokens;
the EnCodec frontend is a stub (input_specs() provides precomputed frame
embeddings summed over the 4 codebooks)."""
from repro_torch.configs.base import ArchConfig, register

MUSICGEN_LARGE = register(ArchConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    act="gelu",
    frontend="audio_stub",
))
