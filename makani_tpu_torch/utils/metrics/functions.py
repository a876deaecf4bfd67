"""Geometric metric functions and 1D quadratures for the rollout curves' AUC.

Counterpart of makani_tpu/utils/metrics/functions.py, on the port's
GridQuadrature: the same weight tables (float32), the same channel and batch
reductions and ACC's eps. The 1D quadrature weights are float32 host tables,
moved to the input's device at each call.
"""

import numpy as np
import torch

from makani_tpu_torch.utils.grids import GridQuadrature


class _GeometricMetric:
    def __init__(self, grid_type, img_shape, crop_shape=None, crop_offset=(0, 0),
                 normalize=False, channel_reduction="mean", batch_reduction="mean",
                 device="cpu"):
        self.quadrature = GridQuadrature(
            grid_type, img_shape=img_shape, crop_shape=crop_shape,
            crop_offset=crop_offset, normalize=normalize, device=device)
        self.channel_reduction = channel_reduction
        self.batch_reduction = batch_reduction

    def _reduce(self, v):
        if self.channel_reduction == "mean":
            v = torch.mean(v, dim=1)
        elif self.channel_reduction == "sum":
            v = torch.sum(v, dim=1)
        if self.batch_reduction == "mean":
            v = torch.mean(v, dim=0)
        elif self.batch_reduction == "sum":
            v = torch.sum(v, dim=0)
        return v


class GeometricL1(_GeometricMetric):
    def __call__(self, x, y):
        return self._reduce(self.quadrature(torch.abs(x - y)))


class GeometricRMSE(_GeometricMetric):
    def __call__(self, x, y):
        return torch.sqrt(self._reduce(self.quadrature(torch.square(x - y))))


class GeometricACC(_GeometricMetric):
    def __init__(self, *args, eps=1e-8, **kwargs):
        super().__init__(*args, **kwargs)
        self.eps = eps

    def __call__(self, x, y):
        cov_xy = self.quadrature(x * y)
        var_x = self.quadrature(torch.square(x))
        var_y = self.quadrature(torch.square(y))
        acc = cov_xy / (torch.sqrt(var_x * var_y) + self.eps)
        return self._reduce(acc)


def _weighted_sum(x, weights, dim):
    shape = [1] * x.ndim
    shape[dim] = -1
    w = torch.from_numpy(weights).to(x.device, x.dtype).reshape(shape)
    return torch.sum(x * w, dim=dim)


class SimpsonQuadrature:
    def __init__(self, num_intervals, interval_width):
        weights = np.zeros(num_intervals + 1, dtype=np.float32)
        if num_intervals % 2 == 0:
            for j in range(1, num_intervals // 2 + 1):
                weights[2 * j - 2] += 1.0
                weights[2 * j - 1] += 4.0
                weights[2 * j] += 1.0
            self.weights = weights * (interval_width / 3.0)
        else:
            raise NotImplementedError("Error, please specify an even number of intervals")

    def __call__(self, x, dim=1):
        return _weighted_sum(x, self.weights, dim)


class TrapezoidQuadrature:
    def __init__(self, num_intervals, interval_width):
        weights = np.full(num_intervals + 1, interval_width, dtype=np.float32)
        weights[0] *= 0.5
        weights[-1] *= 0.5
        self.weights = weights

    def __call__(self, x, dim=1):
        return _weighted_sum(x, self.weights, dim)


class Quadrature:
    """Simpson's rule for an even number of intervals, else the trapezoid."""

    def __init__(self, num_intervals, interval_width):
        if num_intervals % 2 == 0:
            self.quad = SimpsonQuadrature(num_intervals, interval_width)
        else:
            self.quad = TrapezoidQuadrature(num_intervals, interval_width)

    def __call__(self, x, dim=1):
        return self.quad(x, dim)
