from . import scaling
from .algebra import (centrality_correction, cone_div, cone_prod, maxstep,
                      maxstep_to_cone)
from .scaling import NTScaling, nt_identity, nt_inv_adjoint, nt_scaling
from .spec import ConeSpec, SdpGroup, SocGroup, tri_dim, tri_indices, tri_order

__all__ = [
    "ConeSpec",
    "SocGroup",
    "SdpGroup",
    "tri_dim",
    "tri_order",
    "tri_indices",
    "cone_prod",
    "cone_div",
    "maxstep",
    "maxstep_to_cone",
    "centrality_correction",
    "scaling",
    "NTScaling",
    "nt_scaling",
    "nt_identity",
    "nt_inv_adjoint",
]
