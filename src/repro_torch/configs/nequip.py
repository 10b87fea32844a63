"""nequip: 5L d_hidden=32 l_max=2 n_rbf=8 cutoff=5, E(3) tensor products
[arXiv:2101.03164]. Cartesian-irrep implementation.

Port of ``repro/configs/nequip.py``."""
from repro_torch.configs.registry import ArchSpec, GNN_SHAPES, register
from repro_torch.models import gnn

register(ArchSpec(
    "nequip", "gnn",
    lambda: gnn.NequIPConfig(name="nequip", n_layers=5, channels=32, n_rbf=8, cutoff=5.0),
    lambda: gnn.NequIPConfig(name="nequip", n_layers=2, channels=8, n_rbf=4, cutoff=5.0),
    GNN_SHAPES,
))
