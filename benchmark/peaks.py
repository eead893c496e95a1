"""Published peaks of one NVIDIA H100 SXM, and the eval's least work.

Frozen copies of ``chip_smoke.py``'s constants (lines 120-126 there), from
NVIDIA's H100 data sheet: 67 TFLOP/s float32 outside the tensor cores,
which counts a fused multiply-add as two operations, so one non-FMA
instruction per lane and clock is 33.5e12 per second; 3.35 TB/s of HBM3.
Those rates assume the full 700 W power limit.
"""

F32_OPS_PER_S = 33.5e12
HBM_BYTES_PER_S = 3.35e12

# The least work any implementation of a 2D eval does per query: read the
# query (two float32, 8 bytes), write its value (one float32, 4 bytes), and
# one containment test with its weights, 25 operations: two weights from
# the triangle's affine map (2 sub, 4 mul, 4 add), the third (2 sub), their
# min and the compare (3), the weighted sum of three values (3 mul, 2 add)
# and the domain test's select (5).
# The triangle tables are left out: how many of them a batch touches
# depends on the implementation.
EVAL_BYTES_PER_QUERY = 12
EVAL_OPS_PER_QUERY = 25


def eval_floor_s(queries: int) -> float:
    """Least seconds any implementation needs to answer ``queries``."""
    return max(
        queries * EVAL_BYTES_PER_QUERY / HBM_BYTES_PER_S,
        queries * EVAL_OPS_PER_QUERY / F32_OPS_PER_S,
    )
