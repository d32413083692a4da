"""GNN pillar of the port: synthetic Table 2 datasets, GCN/GraphSAGE
modules, full-batch training and the sampled-inference harness."""
from repro_torch.gnn.convert import params_from_numpy
from repro_torch.gnn.datasets import (SYNTHETIC_DATASETS, make_dataset,
                                      table2_stats)
from repro_torch.gnn.infer import evaluate, infer_logits, inference_accuracy
from repro_torch.gnn.models import (GCN, GCNParams, GraphSAGE, SAGEParams,
                                    init_gcn, init_sage, make_presampled_agg)
from repro_torch.gnn.train import cross_entropy, train_model

__all__ = ["GCN", "GraphSAGE", "GCNParams", "SAGEParams", "init_gcn",
           "init_sage", "make_presampled_agg", "SYNTHETIC_DATASETS",
           "make_dataset", "table2_stats", "train_model", "cross_entropy",
           "evaluate", "infer_logits", "inference_accuracy",
           "params_from_numpy"]
