"""Published peaks of one NVIDIA H100 SXM5 80 GB (NVIDIA's H100 data
sheet, dense rates, at the card's 700 W limit): the least time any work
can take is the larger of its operations over the rate and its bytes over
the bandwidth."""

import torch

# FLOP/s: float64 on the tensor cores (the highest float64 rate), float32
# outside them
FLOPS = {torch.float64: 67e12, torch.float32: 67e12}
BYTES_PER_S = 3.35e12


def bound_s(flops, nbytes, dtype) -> float:
    return max(flops / FLOPS[dtype], nbytes / BYTES_PER_S)
