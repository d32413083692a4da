"""xLSTM-350M [arXiv:2405.04517]: sLSTM + mLSTM blocks, 7:1 ratio."""
from repro_torch.configs.base import ArchConfig, register

# 24 blocks, every 8th an sLSTM (xLSTM[7:1]); d_ff=0 — xLSTM blocks carry
# their own up/down projections (expand factor 2).
_PATTERN = tuple("slstm" if (i % 8) == 7 else "mlstm" for i in range(24))

XLSTM_350M = register(ArchConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    block_pattern=_PATTERN,
    ssm_state=64,
    ssm_expand=2,
))
