from .schnet_dense import SchNetDense
from .spherenet import DimeNetPP, SphereNet

__all__ = ["SchNetDense", "SphereNet", "DimeNetPP"]
