"""Model operations: the arithmetic a model's mathematics needs at given
shapes, however the program carries it out.

Counted: every product of a linear layer (2 per multiply-add), the point
convolutions' weight nets and neighbour sums (a multiply and an add per
neighbour and channel), the strided max-pools (one comparison per
neighbour and channel), and each CRF's similarity (3 per neighbour and
channel, 3 per neighbour for the softmax), messages (2 per neighbour and
channel a step) and compatibility transform (two [h, h] products and an
add a step). Not counted: batch norms, activations, residual adds, the
pyramid's search and any data movement. A training step counts
``TRAIN_FACTOR`` forwards: the backward takes two products for each of
the forward's.

Each reference model's ``forward_flops(cfg)`` adds these up over its
layers; ``model_flops(cfg, train)`` is what the ``mfu`` metrics divide.
"""

from __future__ import annotations

PEAK_F32_OPS_PER_S = 67e12     # one H100 SXM, float32 outside the tensor cores
TRAIN_FACTOR = 3


def linear(rows: int, cin: int, cout: int) -> float:
    return 2.0 * rows * cin * cout


def point_conv(m: int, k: int, h: int) -> float:
    """Weight net 3 -> h -> h on each of m * k offsets, and the weighted
    neighbour sum."""
    return linear(m * k, 3, h) + linear(m * k, h, h) + 2.0 * m * k * h


def bottleneck(src: int, m: int, k: int, cin: int, cout: int,
               strided: bool) -> float:
    """PointConvBig's residual block: ``src`` input rows, ``m`` output
    rows, ``k`` neighbours."""
    h = cout // 4
    ops = linear(src, cin, h) + point_conv(m, k, h) + linear(m, h, cout)
    if cin != cout:
        ops += linear(src, cin, cout)
    if strided:
        ops += float(m * k * cout)
    return ops


def similarity(n: int, kc: int, h: int) -> float:
    return n * kc * (3.0 * h + 3.0)


def mean_field(n: int, kc: int, h: int, steps: int) -> float:
    return steps * (2.0 * n * kc * h + 4.0 * n * h * h + n * h)


def continuous_crf(s: int, n: int, kc: int, down: int, skip: int,
                   steps: int) -> float:
    """PointConvBig's CRF block: ``s`` coarse rows, ``n`` fine rows,
    ``kc`` neighbours less the point itself."""
    h = skip // 4
    return (linear(s, down, h) + linear(s, h, h) + linear(n, skip, h)
            + linear(n, h, h) + similarity(n, kc, h)
            + mean_field(n, kc, h, steps) + linear(n, h, skip)
            + linear(n, 2 * skip, skip))


def model_flops(reference, cfg: dict, train: bool) -> float:
    """Operations of one request (a forward) or one training step."""
    f = reference.forward_flops(cfg)
    return TRAIN_FACTOR * f if train else f
