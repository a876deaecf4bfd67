"""Grid quadrature on the sphere.

Counterpart of grid_quadrature_weights and GridQuadrature in
makani_tpu/utils/grids.py. Weight tables are host float64 numpy stored in
float32, one device copy per (quadrature, device). GridConverter (regridding
onto explicit latitudes) is not ported yet (ROADMAP, Queue 1).
"""

import numpy as np
import torch

from makani_tpu_torch.ops.quadrature import (
    clenshaw_curtiss_nodes_weights,
    legendre_gauss_nodes_weights,
)


def grid_quadrature_weights(quadrature_rule, img_shape, normalize=False, pole_mask=None,
                            crop_shape=None, crop_offset=(0, 0)):
    """(H, W) quadrature weight map."""
    if quadrature_rule == "naive":
        jacobian = np.clip(np.sin(np.linspace(0, np.pi, img_shape[0])), 0.0, None)
        dtheta = np.pi / img_shape[0]
        dlambda = 2 * np.pi / img_shape[1]
        dA = dlambda * dtheta
        quad_weight = dA * jacobian[:, None]
        quad_weight = np.tile(quad_weight, (1, img_shape[1]))
        # numerical precision: enforce sum = 4 pi
        quad_weight = quad_weight * (4.0 * np.pi) / np.sum(quad_weight)
    elif quadrature_rule in ("clenshaw-curtiss", "legendre-gauss"):
        nodes = (clenshaw_curtiss_nodes_weights if quadrature_rule == "clenshaw-curtiss"
                 else legendre_gauss_nodes_weights)
        _, w = nodes(img_shape[0], -1, 1)
        dlambda = 2 * np.pi / img_shape[1]
        quad_weight = dlambda * np.flip(w)[:, None]
        quad_weight = np.tile(quad_weight, (1, img_shape[1]))
    else:
        raise ValueError(f"Unknown quadrature rule {quadrature_rule}")

    if normalize:
        quad_weight = quad_weight / (4.0 * np.pi)

    if (pole_mask is not None) and (pole_mask > 0):
        quad_weight[:pole_mask, :] = 0.0
        quad_weight[img_shape[0] - pole_mask:, :] = 0.0

    if crop_shape is not None:
        quad_weight = quad_weight[
            crop_offset[0]: crop_offset[0] + crop_shape[0],
            crop_offset[1]: crop_offset[1] + crop_shape[1],
        ]

    return np.ascontiguousarray(quad_weight, dtype=np.float32)


class GridQuadrature:
    """Quadrature-weighted integral over the last two axes."""

    def __init__(self, quadrature_rule, img_shape, crop_shape=None, crop_offset=(0, 0),
                 normalize=False, pole_mask=None, device="cpu"):
        qw = grid_quadrature_weights(
            quadrature_rule, img_shape, normalize=normalize, pole_mask=pole_mask,
            crop_shape=crop_shape, crop_offset=crop_offset,
        )
        self.quad_weight = torch.from_numpy(qw.reshape(1, 1, *qw.shape)).to(device)

    def __call__(self, x):
        return torch.sum(x * self.quad_weight.to(x.dtype), dim=(-2, -1))
