"""Loss handler: spec-string parsed geometric losses on the sphere.

Counterpart of makani_tpu/utils/losses.py. The loss spec is a token string,
e.g. "weighted squared temp-std geometric l2"; tokens: {l1, l2, geometric h1,
geometric, absolute, squared, weighted, temp-std, pole-masked}. Weight tables
are host numpy, moved once to the loss's device. On spatial ranks the
quadrature-weighted sums (utils/grids.GridQuadrature) and the H1 loss's
spectral sums (through the distributed SHT) add up over the spatial group
before any norm is taken.
"""

import numpy as np
import torch

from makani_tpu_torch.ops.sht import RealSHT
from makani_tpu_torch.parallel import spmd
from makani_tpu_torch.utils.grids import GridQuadrature


def _sum_or_mean(x, size_average):
    return torch.mean(x) if size_average else torch.sum(x)


class GeometricLpLoss:
    """Quadrature-weighted absolute/relative Lp loss on the sphere."""

    def __init__(self, img_shape, crop_shape=None, crop_offset=(0, 0), p=2.0,
                 size_average=False, reduction=True, absolute=False, squared=False,
                 pole_mask=0, jacobian="s2", quadrature_rule="naive", device="cpu"):
        self.p = p
        self.reduction = reduction
        self.size_average = size_average
        self.absolute = absolute
        self.squared = squared
        if jacobian == "flat":
            # uniform weights normalized to 1
            shape = crop_shape if crop_shape is not None else img_shape
            self.quadrature = GridQuadrature(
                None, img_shape, device=device,
                weights=np.full(shape, 1.0 / (shape[0] * shape[1]), dtype=np.float32))
        else:
            self.quadrature = GridQuadrature(
                quadrature_rule, img_shape=img_shape, crop_shape=crop_shape,
                crop_offset=crop_offset, normalize=True, pole_mask=pole_mask, device=device)

    def abs(self, prd, tar, chw):
        num_examples = prd.shape[0]
        all_norms = self.quadrature(torch.abs(prd - tar) ** self.p)
        all_norms = all_norms.reshape(num_examples, -1)
        if not self.squared:
            all_norms = all_norms ** (1.0 / self.p)
        all_norms = chw * all_norms
        return _sum_or_mean(all_norms, self.size_average) if self.reduction else all_norms

    def rel(self, prd, tar, chw):
        num_examples = prd.shape[0]
        diff_norms = self.quadrature(torch.abs(prd - tar) ** self.p).reshape(num_examples, -1)
        tar_norms = self.quadrature(torch.abs(tar) ** self.p).reshape(num_examples, -1)
        frac_norms = diff_norms / tar_norms
        if not self.squared:
            frac_norms = frac_norms ** (1.0 / self.p)
        retval = chw * frac_norms
        return _sum_or_mean(retval, self.size_average) if self.reduction else retval

    def __call__(self, prd, tar, chw):
        return self.abs(prd, tar, chw) if self.absolute else self.rel(prd, tar, chw)


class GeometricH1Loss:
    """SHT-based spectral H1/L2 mixed loss."""

    def __init__(self, img_shape, p=2.0, size_average=False, reduction=True,
                 absolute=False, squared=False, alpha=0.5, device="cpu"):
        self.reduction = reduction
        self.size_average = size_average
        self.absolute = absolute
        self.squared = squared
        self.alpha = alpha
        self.sht = RealSHT(*img_shape, grid="equiangular", device=device)
        h1 = np.arange(self.sht.lmax, dtype=np.float32)
        self.h1_weights = torch.from_numpy(h1 * (h1 + 1)).to(device)

    def _norms2(self, x):
        coeffs = self.sht(x)
        power = coeffs.real ** 2 + coeffs.imag ** 2
        num = x.shape[0]
        if spmd.spatial_distributed():
            # the rank's (l/h, m/w) block: m = 0 counts once, the others
            # twice; the sums over l and m add up over the spatial group
            m0, ml = spmd.patch(self.sht.mmax, "w")
            mw = torch.full((ml,), 2.0, device=x.device)
            if m0 == 0 and ml:
                mw[0] = 1.0
            norm2 = torch.sum(power * mw, dim=-1)                        # (B, C, l/h)
            h1w = self.h1_weights[spmd.patch_slice(self.sht.lmax, "h")]
            l2 = spmd.all_reduce_sum(norm2.reshape(num, -1).sum(dim=-1), "spatial")
            h1 = spmd.all_reduce_sum((norm2 * h1w).reshape(num, -1).sum(dim=-1), "spatial")
            return l2, h1
        norm2 = power[..., 0] + 2 * torch.sum(power[..., 1:], dim=-1)  # (B, C, L)
        l2 = norm2.reshape(num, -1).sum(dim=-1)
        h1 = (norm2 * self.h1_weights).reshape(num, -1).sum(dim=-1)
        return l2, h1

    def _mix(self, l2, h1):
        if not self.squared:
            return self.alpha * torch.sqrt(l2) + (1 - self.alpha) * torch.sqrt(h1)
        return self.alpha * l2 + (1 - self.alpha) * h1

    def __call__(self, prd, tar, chw=None):
        l2, h1 = self._norms2(prd - tar)
        diff = self._mix(l2, h1)
        if self.absolute:
            out = diff
        else:
            tl2, th1 = self._norms2(tar)
            out = diff / self._mix(tl2, th1)
        return _sum_or_mean(out, self.size_average) if self.reduction else out


class LossHandler:
    """Parses the loss spec string and computes the (channel- and
    multistep-weighted) training loss."""

    def __init__(self, params, device="cpu"):
        self.n_future = params.n_future

        self.img_shape = (params.img_shape_x, params.img_shape_y)
        self.crop_shape = (params.img_crop_shape_x, params.img_crop_shape_y)
        self.crop_offset = (params.img_crop_offset_x, params.img_crop_offset_y)

        self.loss_type = params.loss
        loss_type = set(params.loss.split())

        pole_mask = 1 if "pole-masked" in loss_type else 0

        if "weighted" in loss_type:
            if params.channel_weights == "auto":
                channel_weights = np.ones(params.N_out_channels, dtype=np.float32)
                for c, chn in enumerate(params.channel_names):
                    # sst gets zero weight, as in makani_tpu
                    channel_weights[c] = 0.0 if chn in ["sst"] else 1.0
            else:
                channel_weights = np.asarray(params.channel_weights, dtype=np.float32)
        else:
            channel_weights = np.ones(params.N_out_channels, dtype=np.float32)

        channel_weights = channel_weights.reshape(1, -1, 1, 1)
        channel_weights = channel_weights / np.sum(channel_weights)

        absolute = "absolute" in loss_type
        squared = "squared" in loss_type

        if "temp-std" in loss_type:
            eps = 1e-6
            global_stds = np.load(params.global_stds_path).reshape(1, -1, 1, 1)[:, params.out_channels]
            time_diff_stds = np.sqrt(params.dt) * np.load(
                params.time_diff_stds_path).reshape(1, -1, 1, 1)[:, params.out_channels]
            time_var_weights = global_stds / (time_diff_stds + eps)
            if squared:
                time_var_weights = time_var_weights ** 2
            channel_weights = channel_weights * time_var_weights

        multistep_weight = (np.ones((self.n_future + 1, 1, 1, 1), dtype=np.float32)
                            / float(self.n_future + 1))
        cw = channel_weights.astype(np.float32)
        self.channel_weights = torch.from_numpy(cw.reshape(1, -1)).to(device)
        self.train_channel_weights = torch.from_numpy(
            (cw * multistep_weight).reshape(1, -1)).to(device)

        quadrature_rule_type = "naive"
        if params.model_grid_type == "legendre_gauss":
            quadrature_rule_type = "legendre-gauss"

        common = dict(pole_mask=pole_mask, device=device)
        if "l2" in loss_type or "l1" in loss_type:
            p = 2 if "l2" in loss_type else 1
            if "geometric" in loss_type:
                self.loss_obj = GeometricLpLoss(
                    self.img_shape, self.crop_shape, self.crop_offset, p=p, absolute=absolute,
                    squared=squared and p == 2, quadrature_rule=quadrature_rule_type, **common)
            else:
                self.loss_obj = GeometricLpLoss(
                    self.img_shape, self.crop_shape, self.crop_offset, p=p, absolute=absolute,
                    jacobian="flat", **common)
        elif "geometric h1" in self.loss_type:
            self.loss_obj = GeometricH1Loss(self.img_shape, absolute=absolute, squared=squared,
                                            device=device)
        else:
            raise ValueError(f"Unknown loss function: {self.loss_type}")

    def __call__(self, prd, tar, inp=None, training=True):
        chw = self.train_channel_weights if training else self.channel_weights
        return self.loss_obj(prd, tar, chw)
