"""gcn-cora: 2L d_hidden=16 mean aggregator, symmetric norm [arXiv:1609.02907].

Port of ``repro/configs/gcn_cora.py``."""
from repro_torch.configs.registry import ArchSpec, GNN_SHAPES, register
from repro_torch.models import gnn

register(ArchSpec(
    "gcn-cora", "gnn",
    lambda: gnn.GCNConfig(name="gcn-cora", n_layers=2, d_hidden=16),
    lambda: gnn.GCNConfig(name="gcn-cora", n_layers=2, d_hidden=8, d_feat=8, n_classes=4),
    GNN_SHAPES,
))
