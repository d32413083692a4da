"""Config registry of the port: the paper's GNN configurations (the LM
architectures come with the LM pillar)."""
from repro_torch.configs.gnn_paper import PAPER_GNN_CONFIGS, GNNConfig

__all__ = ["GNNConfig", "PAPER_GNN_CONFIGS"]
