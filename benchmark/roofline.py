"""The yardstick of the kernels' roofline shares and of mfu: one H100
SXM's published peaks and the least time a call could take, from its
shapes alone. Frozen copies of `chip_smoke.py::bound`, `k1_bound` and
`bwd_bounds` (with the port's df-scratch formula written out here), plus
the smoother pass's bound of the same file; nothing here imports the
port.

Every fp32-accurate product counts as three TF32 passes on the tensor
cores (3 x work at 495 TFLOP/s), other fp32 work at the 67 TFLOP/s of the
FMA units, bytes at 3.35 TB/s, each input byte read once and each output
byte written once."""

from __future__ import annotations

PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12  # dense, tensor cores
PEAK_BYTES_PER_S = 3.35e12
# the rate of fp32-accurate products formed as three TF32 passes: the
# peak that mfu is read against (the configurations are fp32)
PEAK_FP32_ACCURATE_FLOPS = PEAK_TF32_FLOPS / 3

_DF_TILE = 128  # the backward's df scratch is padded to 128-row tiles


def bound(flop: float, nbytes: float, tf32x3_flop: float = 0.0) -> dict:
    """The least time: the larger of the operations (`flop` on the FMA
    units, `tf32x3_flop` as three TF32 passes on the tensor cores, the two
    side by side) and the bytes at the memory rate."""
    ops_ms = max(flop / PEAK_FP32_FLOPS,
                 3 * tf32x3_flop / PEAK_TF32_FLOPS) * 1e3
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def k1_bound(b: int, nq: int, nk: int, c: int = 256,
             emit_l: bool = False) -> dict:
    """K1 fp32: the scores (2 b nq nk c, fp32-accurate) beside the
    softmax's weights and P.V (2 b nq nk 3 on the FMA units); theta, phi,
    values read once, out and sim (and l) written once."""
    pairs = b * nq * nk
    nbytes = 4 * b * (nq * c + nk * (c + 3) + nq * (4 + emit_l))
    return bound(2 * pairs * 3, nbytes, 2 * pairs * c)


def k2_pass_bound(b: int, h: int, w: int, guides: int) -> dict:
    """One smoother pass over b images of h x w with `guides` guides (b,
    or 1 shared): src and out of 2 fp32 channels a pixel, each guide read
    once; about 30 FLOP a pixel (two weights, three coefficients, the
    solve of two right-hand sides)."""
    return bound(30 * b * h * w, 16 * b * h * w + 4 * guides * h * w)


def df_scratch_bytes(nq: int, nk: int) -> int:
    """Bytes of one sample's df scratch: [Nq', Nk'] fp32, each side
    rounded up to 128 (the port's `cuda_corr.df_scratch_bytes`)."""
    def padded(n):
        return -(-n // _DF_TILE) * _DF_TILE
    return 4 * padded(nq) * padded(nk)


def bwd_bounds(b: int, nq: int, nk: int, c: int) -> dict:
    """The correspondence backward: K3 (`corr_bwd_dkv`: the score pass,
    which writes the df scratch, then dphi from it) and K2b
    (`corr_bwd_dq`: dtheta from the df scratch). Products fp32-accurate;
    dvalues (2 B Nq Nk 3) on the FMA units; each input read once, each
    output written once, the df scratch among K3's outputs and K2b's
    inputs."""
    pairs = b * nq * nk
    prod = 2 * pairs * c
    df_bytes = b * df_scratch_bytes(nq, nk)
    rows_in = 4 * b * nq * (1 + 1 + 1 + 1 + 3)  # m, l, D, d_sim, d_out
    theta_b, phi_b = 4 * b * nq * c, 4 * b * nk * c
    values_b = 4 * b * nk * 3
    return {
        "corr_bwd_dkv": bound(2 * pairs * 3, theta_b + 2 * phi_b
                              + 2 * values_b + rows_in + df_bytes, 2 * prod),
        "corr_bwd_dq": bound(0, df_bytes + phi_b + theta_b, prod),
    }
