from .schnet import SchNet
from .schnet_dense import SchNetDense
from .spherenet import DimeNetPP, SphereNet

__all__ = ["SchNet", "SchNetDense", "SphereNet", "DimeNetPP"]
