"""VMD cubic-Bezier easing curves: runtime LUT evaluation.

Port of `simple_mmd_renderer_tpu/utils/bezier.py`. The load-time half
(`presample`, a NumPy bisection solve into 32-sample LUTs) is host code and
is copied as it is; `lut_eval` indexes the LUT directly (the reference's
one-hot contraction exists only because gathers are slow on a TPU) and gives
the same bits: the contraction sums two products and exact zeros, and at the
last sample it scales lut[31] by (1 - r) + r, which this reproduces.
"""

from __future__ import annotations

import numpy as np
import torch

RESOLUTION = 32
_EPS = 1e-8


def _interpolate_scalar(c0x3, c0y3, c1x3, c1y3, x):
    """Exact eval: 32-iteration bisection for t given x, then y(t)."""
    l, r = np.float32(0.0), np.float32(1.0)
    lm = np.float32(0.0)
    for _ in range(32):
        lm = np.float32((l + r) * 0.5)
        rm = np.float32(1.0 - lm)
        m = np.float32(lm * (rm * (rm * c0x3 + lm * c1x3) + lm * lm))
        if abs(m - x) < _EPS:
            break
        if m > x:
            r = lm
        else:
            l = lm
    rm = np.float32(1.0 - lm)
    return np.float32(lm * (rm * (rm * c0y3 + lm * c1y3) + lm * lm))


def presample(c0: np.ndarray, c1: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Presample a batch of curves -> (lut [..., 32] f32, is_linear [...])."""
    c0 = np.asarray(c0, np.float32)
    c1 = np.asarray(c1, np.float32)
    batch = c0.shape[:-1]
    flat0 = c0.reshape(-1, 2)
    flat1 = c1.reshape(-1, 2)
    n = flat0.shape[0]
    lut = np.empty((n, RESOLUTION), np.float32)
    linear = (flat0[:, 0] == flat0[:, 1]) & (flat1[:, 0] == flat1[:, 1])
    ramp = (np.arange(RESOLUTION, dtype=np.float32)
            / np.float32(RESOLUTION - 1))
    for i in range(n):
        if linear[i]:
            lut[i] = ramp
        else:
            c0x3 = np.float32(flat0[i, 0] * 3)
            c0y3 = np.float32(flat0[i, 1] * 3)
            c1x3 = np.float32(flat1[i, 0] * 3)
            c1y3 = np.float32(flat1[i, 1] * 3)
            for j, x in enumerate(ramp):
                lut[i, j] = _interpolate_scalar(c0x3, c0y3, c1x3, c1y3, x)
    return lut.reshape(batch + (RESOLUTION,)), linear.reshape(batch)


LINEAR_LUT = (np.arange(RESOLUTION, dtype=np.float32)
              / np.float32(RESOLUTION - 1))


def lut_eval(lut, x):
    """Evaluate LUT(s) at x: (1-r)*lut[ix] + r*lut[ix+1], ix = int(31x).

    lut: [..., 32]; x: [...] broadcastable to lut's batch."""
    x = torch.as_tensor(x, dtype=lut.dtype, device=lut.device)
    xs = x * (RESOLUTION - 1)
    ix = torch.clamp(xs.to(torch.int32), 0, RESOLUTION - 1)
    r = xs - ix.to(lut.dtype)
    shape = torch.broadcast_shapes(lut.shape[:-1], ix.shape)
    ix = ix.expand(shape).long()
    r = r.expand(shape)
    lutb = lut.expand(shape + (RESOLUTION,))
    lo = torch.gather(lutb, -1, ix[..., None])[..., 0]
    ix1 = torch.clamp(ix + 1, max=RESOLUTION - 1)
    hi = torch.gather(lutb, -1, ix1[..., None])[..., 0]
    last = ix == RESOLUTION - 1
    return torch.where(last, lo * ((1.0 - r) + r), lo * (1.0 - r) + hi * r)
