"""3D molecular generation: port of ``dig_tpu.ggraph3d`` (SURVEY.md §2.4):
G-SphereNet autoregressive flow placing atoms by (focus, distance, angle,
torsion), its encoder's edge sums through the sorted-CSR kernel on the
card; the QM9-3D step-supervision dataset pipeline and the validity /
bond-MMD / property evaluators (numpy, copies).
"""
from .gspherenet import GSphereNet, SphGenModel
from .dataset import QM93DGEN, steps_from_molecule, collate_steps
from .evaluation import (RandGenEvaluator3D, PropOptEvaluator3D,
                         mols_from_xyz, compute_mmd, bond_stats)

__all__ = [
    "GSphereNet", "SphGenModel",
    "QM93DGEN", "steps_from_molecule", "collate_steps",
    "RandGenEvaluator3D", "PropOptEvaluator3D", "mols_from_xyz",
    "compute_mmd", "bond_stats",
]
