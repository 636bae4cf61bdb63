"""The card's published peaks and the operations and bytes of the work
whose share of them the benchmark reports.

Peaks: NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit:
3.35 TB/s of HBM and 67 TFLOP/s of float32 outside the tensor cores.

K1 (``csrc/mf.cu::mf_tile_kernel``) runs the E-step's annealed mean
field: ``TEMPS`` temperatures of ``SWEEPS`` damped sweeps over a bucket
of R regions, K states, an H x W padded grid. A temperature's sweeps are
split over ``launches`` launches; each launch reads the state
distribution q, the base field and the four edge-weight planes once and
writes q once (float32), and does ``OPS_PER_SWEEP`` float32 operations a
state, pixel and sweep (the kernel table's count: the 8 neighbour terms,
the field, the exponent and the damped update). Its least time is the
larger of its bytes over the memory rate and its operations over the
float32 rate.
"""

from __future__ import annotations

PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12
TEMPS = 5
SWEEPS = 8
OPS_PER_SWEEP = 27


def k1_launch(R: int, K: int, H: int, W: int, sweeps: int):
    """(bytes, float32 operations) of one K1 launch of ``sweeps`` sweeps."""
    px = R * H * W
    nbytes = 4 * (3 * K * px + 4 * px)
    return nbytes, sweeps * OPS_PER_SWEEP * K * px


def least_s(nbytes: float, ops: float) -> float:
    return max(nbytes / PEAK_BYTES_S, ops / PEAK_F32_OPS_S)


def k1_mean_field_least_s(R: int, K: int, H: int, W: int,
                          launches: int) -> float:
    """Least time of one annealed mean field (all temperatures) on a
    bucket, its sweeps split over ``launches`` launches a temperature as
    evenly as whole sweeps allow (the first ones the deeper)."""
    depth = -(-SWEEPS // launches)
    total, left = 0.0, SWEEPS
    for _ in range(launches):
        n = min(depth, left)
        total += least_s(*k1_launch(R, K, H, W, n))
        left -= n
    return TEMPS * total

