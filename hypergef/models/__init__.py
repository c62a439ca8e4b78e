from hypergef.models.layers import HGNNConv, UniGINConv, UniGCNIIConv
from hypergef.models.zoo import HGNN, UniGIN, UniGCNII, build_model

__all__ = [
    "HGNNConv",
    "UniGINConv",
    "UniGCNIIConv",
    "HGNN",
    "UniGIN",
    "UniGCNII",
    "build_model",
]
