"""GNN pillar of the port: synthetic Table 2 datasets, GCN/GraphSAGE
modules, and the sampled-inference harness."""
from repro_torch.gnn.convert import params_from_numpy
from repro_torch.gnn.datasets import SYNTHETIC_DATASETS, make_dataset
from repro_torch.gnn.infer import evaluate, infer_logits, inference_accuracy
from repro_torch.gnn.models import GCN, GraphSAGE, init_gcn, init_sage

__all__ = ["GCN", "GraphSAGE", "init_gcn", "init_sage", "SYNTHETIC_DATASETS",
           "make_dataset", "evaluate", "infer_logits", "inference_accuracy",
           "params_from_numpy"]
