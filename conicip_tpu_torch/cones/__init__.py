from . import scaling
from .algebra import (centrality_correction, cone_div, cone_prod, lyap_solve,
                      maxstep, maxstep_multi, maxstep_to_cone, sdp_eighs)
from .scaling import NTScaling, nt_identity, nt_inv_adjoint, nt_scaling
from .spec import ConeSpec, SdpGroup, SocGroup, tri_dim, tri_indices, tri_order
from .symm import mat, vecm

__all__ = [
    "ConeSpec",
    "SocGroup",
    "SdpGroup",
    "tri_dim",
    "tri_order",
    "tri_indices",
    "mat",
    "vecm",
    "cone_prod",
    "cone_div",
    "maxstep",
    "maxstep_multi",
    "sdp_eighs",
    "maxstep_to_cone",
    "lyap_solve",
    "centrality_correction",
    "scaling",
    "NTScaling",
    "nt_scaling",
    "nt_identity",
    "nt_inv_adjoint",
]
