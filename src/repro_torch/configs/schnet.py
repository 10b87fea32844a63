"""schnet: 3 interactions d_hidden=64 rbf=300 cutoff=10 [arXiv:1706.08566].

Port of ``repro/configs/schnet.py``."""
from repro_torch.configs.registry import ArchSpec, GNN_SHAPES, register
from repro_torch.models import gnn

register(ArchSpec(
    "schnet", "gnn",
    lambda: gnn.SchNetConfig(name="schnet", n_interactions=3, d_hidden=64, n_rbf=300, cutoff=10.0),
    lambda: gnn.SchNetConfig(name="schnet", n_interactions=2, d_hidden=16, n_rbf=16, cutoff=6.0),
    GNN_SHAPES,
))
