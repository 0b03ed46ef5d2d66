from .synthetic import (morse_energy, synthetic_molecules,
                        synthetic_morse_molecules)
from .loader import (BucketedDenseMoleculeLoader, BucketedMoleculeLoader,
                     DenseMoleculeLoader, MoleculeLoader,
                     PackedDenseMoleculeLoader)

__all__ = ["synthetic_molecules", "synthetic_morse_molecules",
           "morse_energy", "MoleculeLoader", "DenseMoleculeLoader",
           "PackedDenseMoleculeLoader", "BucketedDenseMoleculeLoader",
           "BucketedMoleculeLoader"]
