"""Operations, bytes and the least time of the two correspondence kernels,
counted from the algorithm's shapes and the engine's counters (so the count
reads the same whatever implements the search), against the published peaks
of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, 700 W).

A distance is 8 float32 operations in the difference form: 3 subtractions,
3 products, 2 additions. The kernels must be exact (first-index argmin of
that very expression), so no multiply-add fuses two of them: a kernel of
this form issues 8 instructions a distance where the 67 TFLOP/s peak
counts an FMA as two operations, and so cannot read above 50% of it."""

from __future__ import annotations

PEAK_FP32_FLOPS = 67.0e12       # FLOP/s, float32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12        # bytes/s
FLOPS_PER_DISTANCE = 8
F32 = 4


def bound_s(flops: float, nbytes: float) -> float:
    """The least time: the larger of compute at peak and bytes at peak."""
    return max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES)


def k1_launch(lanes: int, sources: int, window: int, target_rows: int):
    """``(flops, bytes)`` of one K1 (``match_slab``) launch: every sample row
    against the ``window`` target rows of its tile. Bytes: the sources
    (xyz) and the packed target rows (xyz, normal, 2 pad) read once, the
    matched rows (8 floats), distance and index written once."""
    flops = FLOPS_PER_DISTANCE * lanes * sources * window
    nbytes = lanes * (sources * 3 * F32 + target_rows * 8 * F32
                      + sources * (8 * F32 + F32 + 4))
    return flops, nbytes


def k2_launch(lanes: int, valid_sources: int, valid_targets: int,
              sources: int, targets: int):
    """``(flops, bytes)`` of one K2 (``nn1``) launch: every valid source row
    against every valid target row. Bytes: the sources and targets (xyz)
    read once, index and distance written once per source row."""
    flops = FLOPS_PER_DISTANCE * lanes * valid_sources * valid_targets
    nbytes = lanes * (sources * 3 * F32 + targets * 3 * F32 + sources * (4 + F32))
    return flops, nbytes
