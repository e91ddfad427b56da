"""The Sinkhorn potentials' work from shapes and the configured iterations:
every iteration updates f over all (i, j) pairs and then g over all of
them. A pair costs, a direction: 6 for the three multiply-adds of x.y, 2 to
form the cost from the squared norms, 2 for the exponent (subtract the
potential, scale by 1/eps), 1 exponential and 1 addition into the row's
sum: 12 operations, the exponential counted as one. Bytes: each input
point read once (3 floats) and each potential written once."""

from __future__ import annotations

OPS_PER_PAIR = 12


def potentials_ops(b: int, n: int, m: int, iters: int) -> int:
    return b * n * m * 2 * iters * OPS_PER_PAIR


def potentials_bytes(b: int, n: int, m: int) -> int:
    return b * (n + m) * (3 * 4 + 4)


def least_seconds(b: int, n: int, m: int, iters: int, flops_per_s: float,
                  bytes_per_s: float) -> float:
    """The time at the chip's peak: the larger of operations over its
    operation rate and bytes over its memory bandwidth."""
    return max(potentials_ops(b, n, m, iters) / flops_per_s,
               potentials_bytes(b, n, m) / bytes_per_s)
