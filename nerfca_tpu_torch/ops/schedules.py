"""Loss-weight annealing schedules (port of ``nerfca_tpu/ops/schedules.py``),
evaluated on the host in float32, the precision the JAX step computes them
in."""

from __future__ import annotations

import numpy as np


def linear_param_decay(step, start_weight, end_weight, steps, delay_steps=0) -> float:
    """Linear ramp from ``start_weight`` to ``end_weight`` over ``steps``
    iterations, 0 before ``delay_steps``."""
    f = np.float32
    if f(step) < f(delay_steps):
        return 0.0
    alpha = min(f(f(step) - f(delay_steps)) / f(steps), f(1.0))
    return float((f(1.0) - alpha) * f(start_weight) + alpha * f(end_weight))


def exp_param_decay(step, start_weight, end_weight, steps, delay_steps=0) -> float:
    """Exponential interpolation from ``start_weight`` to ``end_weight``,
    ``end_weight`` from ``steps`` on and 0 before ``delay_steps``. The
    reference's quirk is kept: the exponent is ``step / (steps - 1)``,
    without the delay."""
    f = np.float32
    if f(step) < f(delay_steps):
        return 0.0
    if start_weight == end_weight:
        return float(f(start_weight))
    if f(step) >= f(steps):
        return float(f(end_weight))
    base = f(end_weight) / f(start_weight)
    return float(f(start_weight) * base ** (f(step) / f(f(steps) - f(1))))
