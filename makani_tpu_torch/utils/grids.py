"""Grid quadrature on the sphere and latitude-grid conversion.

Counterpart of GridConverter, grid_quadrature_weights and GridQuadrature in
makani_tpu/utils/grids.py. Weight tables are host float64 numpy stored in
float32, one device copy per (quadrature, device). GridConverter regrids the
datasets' numpy samples on the host and takes torch tensors too.
"""

import numpy as np
import torch

from makani_tpu_torch.parallel import spmd

from makani_tpu_torch.ops.quadrature import (
    clenshaw_curtiss_nodes_weights,
    legendre_gauss_nodes_weights,
)


class GridConverter:
    """Equiangular -> Legendre-Gauss latitude regridding by linear
    interpolation. lat/lon in radians, in the data's latitude order; the
    left neighbour of each target latitude is found by searchsorted on the
    (descending) source grid."""

    def __init__(self, src_grid, dst_grid, lat_rad, lon_rad):
        self.src = src_grid
        self.dst = dst_grid
        self.src_lat = np.asarray(lat_rad, dtype=np.float64)
        self.src_lon = np.asarray(lon_rad, dtype=np.float64)

        if self.src == self.dst:
            self.dst_lat, self.dst_lon = self.src_lat, self.src_lon
            return
        if self.dst != "legendre-gauss":
            raise NotImplementedError(f"Error, destination grid type {self.dst} not implemented.")
        cost_lg, _ = legendre_gauss_nodes_weights(self.src_lat.shape[0], -1, 1)
        self.dst_lat = np.arccos(cost_lg) - np.pi / 2.0
        self.dst_lon = self.src_lon

        # indices of the left neighbour in the (descending) source grid
        permutation = np.arange(self.src_lat.shape[0] - 1, -1, -1)
        jj = np.searchsorted(self.src_lat, self.dst_lat, sorter=permutation) - 1
        self.indices = jj[permutation]
        self.interp_weights = (
            (self.dst_lat - self.src_lat[self.indices])
            / np.diff(self.src_lat)[np.clip(self.indices, 0, len(self.src_lat) - 2)]
        ).reshape(-1, 1).astype(np.float32)

    def get_src_coords(self):
        return self.src_lat, self.src_lon

    def get_dst_coords(self):
        return self.dst_lat, self.dst_lon

    def __call__(self, data):
        """Regrid the latitude axis (-2) of a numpy array or a tensor."""
        if self.src == self.dst:
            return data
        lo = data[..., self.indices, :]
        hi = data[..., self.indices + 1, :]
        if isinstance(data, torch.Tensor):
            w = torch.from_numpy(self.interp_weights).to(data.device, data.dtype)
        else:
            w = self.interp_weights.astype(data.dtype)
        return lo + (hi - lo) * w


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
    """Quadrature-weighted integral over the last two axes. On spatial ranks
    it takes the rank's patch of the (cropped) field, weighs it with its
    patch of the weights and sums the patches' integrals over the spatial
    group (the cotangent of the replicated result passes through)."""

    def __init__(self, quadrature_rule, img_shape, crop_shape=None, crop_offset=(0, 0),
                 normalize=False, pole_mask=None, device="cpu", weights=None):
        qw = weights if weights is not None else grid_quadrature_weights(
            quadrature_rule, img_shape, normalize=normalize, pole_mask=pole_mask,
            crop_shape=crop_shape, crop_offset=crop_offset,
        )
        qw = np.ascontiguousarray(spmd.local_patch(qw, qw.shape))
        self.quad_weight = torch.from_numpy(qw.reshape(1, 1, *qw.shape)).to(device)

    def __call__(self, x):
        return spmd.all_reduce_sum(torch.sum(x * self.quad_weight.to(x.dtype), dim=(-2, -1)),
                                   "spatial")
