"""The paper's own workload configs: GCN / GraphSAGE x six graphs."""
from dataclasses import dataclass


@dataclass(frozen=True)
class GNNConfig:
    model: str           # gcn | graphsage
    dataset: str
    hidden: int = 64
    sh_width: int = 128
    strategy: str = "aes"
    quantize_bits: int | None = None


PAPER_GNN_CONFIGS = {
    f"{m}-{d}": GNNConfig(model=m, dataset=d)
    for m in ("gcn", "graphsage")
    for d in ("cora", "pubmed", "ogbn-arxiv", "reddit", "ogbn-proteins",
              "ogbn-products")
}
