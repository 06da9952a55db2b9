from .generators import (ALL_GENERATORS, Problem, batched_box_qp,
                         batched_mixed_rq_eq, batched_mixed_rqs,
                         batched_small_sdp, box_qp_dense, box_qp_sparse,
                         larger_sdp, many_small_socs, mixed_rq_eq, mixed_rqs,
                         single_soc, small_sdp)

__all__ = ["Problem", "box_qp_dense", "box_qp_sparse", "single_soc",
           "many_small_socs", "small_sdp", "larger_sdp", "mixed_rq_eq",
           "mixed_rqs", "batched_box_qp", "batched_small_sdp",
           "batched_mixed_rq_eq", "batched_mixed_rqs", "ALL_GENERATORS"]
