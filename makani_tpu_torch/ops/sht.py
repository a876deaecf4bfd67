"""Real spherical harmonic transforms (analysis / synthesis), stacked-real form.

Counterpart of makani_tpu/ops/sht.py. The SHT is a truncated longitude DFT
(one float32 torch.matmul against a [cos | -sin] table) followed by a per-m
Legendre contraction over latitude (the legmm kernel, ops/spectral_mm.py).
Coefficients live in the m-leading stacked-real layout (2*mmax, ..., lmax),
re rows then im rows; `__call__` is a thin complex-layout wrapper over it.

Conventions (as makani_tpu, parity with torch-harmonics):
  - analysis:  c_lm = sum_k w_k P-hat_l^m(theta_k) * (2 pi / nlon) sum_j x e^{-im phi_j}
  - synthesis: x(theta_k, phi_j) = Re sum_m fac_m e^{im phi} sum_l c_lm P-hat_l^m
  - "ortho" normalization, Condon-Shortley phase, theta in [0, pi]
    (north pole first, ERA5 ordering).

The quadrature weights multiply the DFT output before the Legendre
contraction, so one (mmax, lmax, nlat) table serves both directions of a grid.
Tables are float64 host precomputes stored in float32, one device copy per
(grid, device). The longitude DFT is a float32 matmul whatever the precision
mode: on the GPU it keeps full float32 while TF32 matmuls are off (PyTorch's
default).
"""

from functools import lru_cache

import numpy as np
import torch

from makani_tpu_torch.ops import spectral_mm
from makani_tpu_torch.ops.dft import irdft_matrices, rdft_matrices
from makani_tpu_torch.ops.legendre import precompute_legpoly
from makani_tpu_torch.ops.quadrature import quadrature_nodes_weights

# bf16 passes of the coefficient-space contractions per precision mode
# (makani_tpu/ops/sht.py:42-107). "high" (3 passes, ~16-bit operands) is the
# serving default. "highest" has no kernel equivalent and is not ported.
_PASSES = {"default": 1, "split2": 2, "tf32": 3, "mixed": 3, "mixed2": 3, "high": 3}
_PRECISION = "high"


def set_transform_precision(name: str):
    global _PRECISION
    if name not in _PASSES:
        raise ValueError(f"unknown transform precision {name!r}; one of {sorted(_PASSES)}")
    _PRECISION = name


def get_transform_precision():
    return _PRECISION


def _coeff_passes():
    """bf16 pass count of the coefficient-space kernels for the current mode."""
    return _PASSES[_PRECISION]


# Coefficient engine: how the Legendre contractions and the dhconv channel
# mixing execute. Both go through the differentiable wrappers of
# ops/spectral_mm (legdot, dhconv), so gradients are the multi-pass products
# of the cotangents on either engine.
#   "kernel"  — the Hopper kernels (their plain twins for CPU tensors); the
#               default
#   "stacked" — the plain PyTorch twins on any device (the reference the
#               kernels are held against on the card)
# The complex einsum engine ("xla" in makani_tpu) is not ported yet.
_COEFF_ENGINE = "kernel"


def set_coeff_engine(name: str):
    global _COEFF_ENGINE
    if name == "xla":
        raise NotImplementedError(
            "the complex 'xla' coefficient engine is not ported yet (ROADMAP: Queue 1)")
    if name not in ("kernel", "stacked"):
        raise ValueError(f"unknown coefficient engine {name!r}")
    _COEFF_ENGINE = name


def get_coeff_engine():
    return _COEFF_ENGINE


def _legendre_dot(z, p, contract):
    """(2*mmax, R, K|L) x (mmax, L, K) per-m contraction on the active engine."""
    return spectral_mm.legdot(z, p, contract, _coeff_passes(), plain=_COEFF_ENGINE == "stacked")


@lru_cache(maxsize=None)
def _theta_weights(grid, nlat):
    cost, w = quadrature_nodes_weights(grid, nlat, -1.0, 1.0)
    # theta in [0, pi], ascending (north pole first)
    return np.flip(np.arccos(cost)).copy(), np.flip(w).copy()


@lru_cache(maxsize=None)
def _get_pct(grid, nlat, lmax, mmax):
    """Shared (mmax, lmax, nlat) Legendre table of a grid (float32)."""
    tq, _ = _theta_weights(grid, nlat)
    pct = precompute_legpoly(mmax, lmax, tq, norm="ortho", csphase=True)
    return np.ascontiguousarray(pct, dtype=np.float32)


@lru_cache(maxsize=None)
def _pct_tensor(grid, nlat, lmax, mmax, device):
    return torch.from_numpy(_get_pct(grid, nlat, lmax, mmax)).to(device)


@lru_cache(maxsize=None)
def _rdft_tensor(nlon, mmax, device):
    """(2*mmax, nlon) [cos ; -sin] analysis operand, m leading."""
    C, S = rdft_matrices(nlon, mmax, scale="integral")
    return torch.from_numpy(np.concatenate([C, -S], axis=1).T.copy()).to(device)


@lru_cache(maxsize=None)
def _irdft_tensor(nlon, mmax, device):
    """(2*mmax, nlon) [cos ; -sin] synthesis operand."""
    Cs, Ss = irdft_matrices(nlon, mmax, scale="synthesis")
    return torch.from_numpy(np.concatenate([Cs, -Ss], axis=0)).to(device)


class RealSHT:
    """Analysis: real (..., nlat, nlon) -> complex (..., lmax, mmax)."""

    def __init__(self, nlat, nlon, lmax=None, mmax=None, grid="lobatto", csphase=True,
                 device="cpu"):
        if not csphase:
            raise NotImplementedError("only the Condon-Shortley phase convention is ported")
        self.nlat = nlat
        self.nlon = nlon
        self.grid = grid
        self.lmax = lmax or self.nlat
        self.mmax = mmax or self.nlon // 2 + 1
        self.device = torch.device(device)
        _, wq = _theta_weights(grid, nlat)
        self.wq = torch.as_tensor(wq, dtype=torch.float32).to(self.device)
        self.pct = _pct_tensor(grid, nlat, self.lmax, self.mmax, self.device)
        self.dft = _rdft_tensor(nlon, self.mmax, self.device)

    def analysis_stacked(self, x):
        """Real grid (..., nlat, nlon) -> m-leading stacked-real coefficients
        (2*mmax, ..., lmax), re rows then im rows."""
        batch_shape = x.shape[:-2]
        xf = x.float().reshape(-1, self.nlon)                 # (R*nlat, nlon)
        z = torch.matmul(self.dft, xf.T)                       # (2*mmax, R*nlat)
        z = z.view(2 * self.mmax, -1, self.nlat).mul_(self.wq)
        out = _legendre_dot(z, self.pct, "k")                  # (2*mmax, R, lmax)
        return out.view(2 * self.mmax, *batch_shape, self.lmax)

    def __call__(self, x):
        z = self.analysis_stacked(x)
        return torch.complex(z[: self.mmax], z[self.mmax:]).movedim(0, -1)


class InverseRealSHT:
    """Synthesis: complex (..., lmax, mmax) -> real (..., nlat, nlon)."""

    def __init__(self, nlat, nlon, lmax=None, mmax=None, grid="lobatto", csphase=True,
                 device="cpu"):
        if not csphase:
            raise NotImplementedError("only the Condon-Shortley phase convention is ported")
        self.nlat = nlat
        self.nlon = nlon
        self.grid = grid
        self.lmax = lmax or self.nlat
        self.mmax = mmax or self.nlon // 2 + 1
        self.device = torch.device(device)
        # ortho normalization: the synthesis table equals the analysis table
        self.pct = _pct_tensor(grid, nlat, self.lmax, self.mmax, self.device)
        self.dft = _irdft_tensor(nlon, self.mmax, self.device)

    def synthesis_stacked(self, z):
        """m-leading stacked-real coefficients (2*mmax, ..., lmax) -> real grid
        (..., nlat, nlon). The twin of RealSHT.analysis_stacked."""
        batch_shape = z.shape[1:-1]
        zf = z.reshape(z.shape[0], -1, z.shape[-1]).contiguous()
        o = _legendre_dot(zf, self.pct, "l")                   # (2*mmax, R, nlat)
        out = torch.matmul(o.view(o.shape[0], -1).T, self.dft)  # (R*nlat, nlon)
        return out.view(*batch_shape, self.nlat, self.nlon)

    def __call__(self, x):
        x = x.to(torch.complex64)
        z = torch.cat([x.real.movedim(-1, 0), x.imag.movedim(-1, 0)], dim=0)
        return self.synthesis_stacked(z)
