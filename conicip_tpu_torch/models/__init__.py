from .generators import Problem, box_qp_dense, box_qp_sparse

__all__ = ["Problem", "box_qp_dense", "box_qp_sparse"]
