"""Config registry of the port: the paper's GNN configurations and the ten
LM architectures (importing this package registers all of them)."""
from repro_torch.configs.base import (ArchConfig, MLAConfig, MoEConfig,
                                      get_config, list_configs, register,
                                      smoke_config)
from repro_torch.configs.xlstm_350m import XLSTM_350M
from repro_torch.configs.qwen2_7b import QWEN2_7B
from repro_torch.configs.tinyllama_1_1b import TINYLLAMA_1_1B
from repro_torch.configs.qwen1_5_0_5b import QWEN1_5_0_5B
from repro_torch.configs.gemma_7b import GEMMA_7B
from repro_torch.configs.mixtral_8x22b import MIXTRAL_8X22B
from repro_torch.configs.deepseek_v2_236b import DEEPSEEK_V2_236B
from repro_torch.configs.zamba2_7b import ZAMBA2_7B
from repro_torch.configs.pixtral_12b import PIXTRAL_12B
from repro_torch.configs.musicgen_large import MUSICGEN_LARGE
from repro_torch.configs.gnn_paper import PAPER_GNN_CONFIGS, GNNConfig

ALL_ARCHS = list_configs()

# assigned input shapes (seq_len, global_batch, kind)
SHAPES = {
    "train_4k": (4_096, 256, "train"),
    "prefill_32k": (32_768, 32, "prefill"),
    "decode_32k": (32_768, 128, "decode"),
    "long_500k": (524_288, 1, "decode"),
}

__all__ = ["ArchConfig", "MLAConfig", "MoEConfig", "get_config",
           "list_configs", "register", "smoke_config", "ALL_ARCHS",
           "SHAPES", "GNNConfig", "PAPER_GNN_CONFIGS"]
