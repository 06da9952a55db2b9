from .generators import (Problem, batched_mixed_rq_eq, box_qp_dense,
                         box_qp_sparse, larger_sdp, many_small_socs,
                         mixed_rq_eq, mixed_rqs, single_soc, small_sdp)

__all__ = ["Problem", "box_qp_dense", "box_qp_sparse", "single_soc",
           "many_small_socs", "small_sdp", "larger_sdp", "mixed_rq_eq",
           "mixed_rqs", "batched_mixed_rq_eq"]
