"""equiformer-v2: 12L d_hidden=128 l_max=6 m_max=2 8 heads, SO(2)-eSCN
convolutions [arXiv:2306.12059].

Port of ``repro/configs/equiformer_v2.py``."""
from repro_torch.configs.registry import ArchSpec, GNN_SHAPES, register
from repro_torch.models import gnn

register(ArchSpec(
    "equiformer-v2", "gnn",
    lambda: gnn.EquiformerConfig(name="equiformer-v2", n_layers=12, channels=128,
                                 l_max=6, m_max=2, n_heads=8),
    lambda: gnn.EquiformerConfig(name="equiformer-v2", n_layers=2, channels=16,
                                 l_max=3, m_max=2, n_heads=4, n_rbf=8),
    GNN_SHAPES,
))
