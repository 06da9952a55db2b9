"""Dense linear-algebra kernels of the PyTorch port.

The exports are the reference's (``conicip_tpu/ops/__init__.py``): the
function :func:`cholesky` shadows its submodule as an attribute, as there;
``conicip_tpu_torch.ops.cholesky`` is still importable by module path.
"""
from .cholesky import cholesky, cho_solve, CholFactor

__all__ = ["cholesky", "cho_solve", "CholFactor"]
