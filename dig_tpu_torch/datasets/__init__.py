from .qm9 import QM93D
from .md17 import MD17
from .synthetic import (morse_energy, synthetic_crystals,
                        synthetic_molecules, synthetic_morse_molecules)
from .loader import (BucketedDenseMoleculeLoader, BucketedMoleculeLoader,
                     DenseMoleculeLoader, MoleculeLoader,
                     PackedDenseMoleculeLoader)
from .graphs import (GraphClsLoader, degree_onehot, load_tu_dataset,
                     synthetic_graph_dataset)
from .proteins import (ECdataset, FOLDdataset, ProteinLoader,
                       synthetic_proteins)

__all__ = ["QM93D", "MD17", "synthetic_molecules",
           "synthetic_morse_molecules", "morse_energy", "synthetic_crystals",
           "MoleculeLoader", "DenseMoleculeLoader",
           "PackedDenseMoleculeLoader", "BucketedDenseMoleculeLoader",
           "BucketedMoleculeLoader", "GraphClsLoader",
           "synthetic_graph_dataset", "load_tu_dataset", "degree_onehot",
           "ECdataset", "FOLDdataset", "ProteinLoader", "synthetic_proteins"]
