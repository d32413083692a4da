"""Architecture config schema + registry for the 10 assigned architectures.

The port's copy of the reference package's schema, field for field and
default for default.  Every field is static metadata and configs are
hashable; ``--arch <id>`` resolves through
``repro_torch.configs.get_config``.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 multi-head latent attention."""
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None       # default d_model // num_heads
    # attention details
    attn_bias: bool = False              # qwen-style QKV bias
    sliding_window: Optional[int] = None  # mixtral SWA
    mla: Optional[MLAConfig] = None      # deepseek-v2
    act: str = "silu"                    # silu (SwiGLU) | gelu (GeGLU)
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # moe
    moe: Optional[MoEConfig] = None
    # ssm / recurrent families
    ssm_state: int = 0                   # mamba2 state dim
    ssm_conv: int = 4
    ssm_expand: int = 2
    block_pattern: Optional[Tuple[str, ...]] = None
    #   pattern entries: "attn" | "mamba" | "shared_attn" | "mlstm" | "slstm"
    attn_every: int = 0                  # zamba2: shared attn period
    # modality frontend ("vision_stub" | "audio_stub" | None); stubs mean
    # input_specs() provides precomputed patch/frame embeddings
    frontend: Optional[str] = None
    # paper-technique transfer: AES-KV sampling budget for decode (opt-in)
    aes_kv_width: Optional[int] = None
    # paper-technique transfer: INT8 KV-cache quantization (Eq. 1-2 applied
    # to the cache; halves decode HBM cache traffic) (opt-in)
    kv_quant_bits: Optional[int] = None
    # perf levers (§Perf hillclimb): remat policy + bf16 logits
    remat_policy: Optional[str] = None   # None | "dots" | "nothing"
    bf16_logits: bool = False
    # H1b: pin activations to pure-DP sharding inside replicated-weight
    # blocks (stops GSPMD improvising shardings on an idle model axis)
    activation_dp: bool = False
    # training defaults
    param_dtype: str = "bfloat16"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run long_500k (long-context decode) within spec?"""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.sliding_window is not None

    def with_aes_kv(self, width: int) -> "ArchConfig":
        return replace(self, aes_kv_width=width)

    def with_options(self, **kw) -> "ArchConfig":
        return replace(self, **kw)

    def param_count_dense(self) -> int:
        """Rough N for 6ND model-FLOP accounting (active params for MoE)."""
        d, L, V = self.d_model, self.num_layers, self.vocab_size
        hd = self.resolved_head_dim
        emb = V * d * (1 if self.tie_embeddings else 2)
        if self.mla is not None:
            m = self.mla
            attn = (d * m.q_lora_rank + m.q_lora_rank * self.num_heads *
                    (m.nope_head_dim + m.rope_head_dim) +
                    d * (m.kv_lora_rank + m.rope_head_dim) +
                    m.kv_lora_rank * self.num_heads *
                    (m.nope_head_dim + m.v_head_dim) +
                    self.num_heads * m.v_head_dim * d)
        else:
            attn = (d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd
                    + self.num_heads * hd * d)
        if self.moe is not None:
            ff_active = 3 * d * self.moe.d_ff_expert * (
                self.moe.top_k + self.moe.num_shared_experts)
            router = d * self.moe.num_experts
            ff = ff_active + router
        elif self.d_ff:
            ff = 3 * d * self.d_ff
        else:
            ff = 0
        if self.family == "ssm":
            inner = self.ssm_expand * d
            blk = d * inner * 3 + inner * d  # rough xlstm/mamba proj count
            return emb + L * blk
        per_layer = attn + ff
        if self.family == "hybrid":
            # "active params per token": weight-shared attention+mlp still
            # costs compute per application, so count per application
            inner = self.ssm_expand * d
            mamba_blk = 2 * d * inner + inner * d + inner * (2 * self.ssm_state)
            blocks = self.block_pattern or ()
            n_attn = (len([b for b in blocks if "attn" in b]) if blocks
                      else max(L // max(self.attn_every, 1), 1))
            n_mamba = L - n_attn
            return emb + n_mamba * mamba_blk + n_attn * (attn + 3 * d * self.d_ff)
        return emb + L * per_layer


_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    import repro_torch.configs  # noqa: F401  (populates the registry)

    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> list[str]:
    import repro_torch.configs  # noqa: F401

    return sorted(_REGISTRY)


def smoke_config(cfg: ArchConfig) -> ArchConfig:
    """Reduced same-family config for CPU smoke tests: few layers, narrow,
    tiny vocab/experts — structure preserved."""
    kw: dict = dict(
        num_layers=min(cfg.num_layers, 2 if not cfg.block_pattern else
                       len(cfg.block_pattern[:4])),
        d_model=128,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 4) if cfg.num_kv_heads < cfg.num_heads else 4,
        head_dim=32,
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=512,
        sliding_window=min(cfg.sliding_window, 16) if cfg.sliding_window else None,
    )
    if cfg.moe is not None:
        kw["moe"] = MoEConfig(num_experts=4, top_k=min(cfg.moe.top_k, 2),
                              d_ff_expert=128,
                              num_shared_experts=min(cfg.moe.num_shared_experts, 1))
    if cfg.mla is not None:
        kw["mla"] = MLAConfig(kv_lora_rank=64, q_lora_rank=96,
                              rope_head_dim=16, nope_head_dim=32, v_head_dim=32)
    if cfg.ssm_state:
        kw["ssm_state"] = min(cfg.ssm_state, 16)
    if cfg.attn_every:
        # grouped hybrid: keep >= 2 full groups so the group-scan path runs
        kw["attn_every"] = 3
        kw["num_layers"] = 6
        kw["block_pattern"] = tuple(
            "shared_attn" if (i % 3) == 2 else "mamba" for i in range(6))
    elif cfg.block_pattern:
        kw["block_pattern"] = cfg.block_pattern[:kw["num_layers"]]
    return replace(cfg, **kw)
