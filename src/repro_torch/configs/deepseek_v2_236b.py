"""DeepSeek-V2-236B [arXiv:2405.04434]: MLA (kv_lora=512), 2 shared + 160
routed experts top-6, expert d_ff=1536."""
from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig, register

DEEPSEEK_V2_236B = register(ArchConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,
    d_ff=1536,
    vocab_size=102400,
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536,
                  rope_head_dim=64, nope_head_dim=128, v_head_dim=128),
    moe=MoEConfig(num_experts=160, top_k=6, d_ff_expert=1536,
                  num_shared_experts=2),
))
