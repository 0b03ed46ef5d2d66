from .comenet import ComENet, ComENetOCP
from .pronet import ProNet
from .schnet import SchNet
from .schnet_dense import SchNetDense
from .spherenet import DimeNetPP, SphereNet

__all__ = ["SchNet", "SchNetDense", "SphereNet", "DimeNetPP", "ComENet",
           "ComENetOCP", "ProNet"]
