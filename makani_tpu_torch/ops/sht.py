"""Real spherical harmonic transforms (analysis / synthesis).

Counterpart of makani_tpu/ops/sht.py. The SHT is a truncated longitude DFT
(one float32 torch.matmul against a [cos | -sin] table) followed by a per-m
Legendre contraction over latitude. The coefficient engine decides how that
contraction runs (`set_coeff_engine`):
  - "kernel" and "stacked" (the stacked-real pipeline): coefficients in the
    m-leading layout (2*mmax, ..., lmax), re rows then im rows, contracted by
    the legmm kernel or its plain twin (ops/spectral_mm.py); `__call__` is a
    thin complex-layout wrapper over `analysis_stacked`/`synthesis_stacked`;
  - "xla" (makani_tpu's default): `__call__` contracts the complex layout
    (..., lmax, mmax) with float32 einsums, as makani_tpu's `__call__` does.

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

# bf16 passes of the coefficient-space kernels per precision mode
# (makani_tpu/ops/sht.py:42-107). "high" (3 passes, ~16-bit operands) is the
# serving default. "highest" (strict float32) has no kernel equivalent: it
# runs on the complex "xla" path whatever the engine, as in makani_tpu.
_PASSES = {"default": 1, "split2": 2, "tf32": 3, "mixed": 3, "mixed2": 3, "high": 3}
_PRECISIONS = (*_PASSES, "highest")
_PRECISION = "high"


def set_transform_precision(name: str):
    global _PRECISION
    if name not in _PRECISIONS:
        raise ValueError(f"unknown transform precision {name!r}; one of {sorted(_PRECISIONS)}")
    _PRECISION = name


def get_transform_precision():
    return _PRECISION


def _coeff_passes():
    """bf16 pass count of the coefficient-space kernels for the current mode
    (None under "highest": no kernel equivalent)."""
    return _PASSES.get(_PRECISION)


# Coefficient engine: how the Legendre contractions and SpectralConv's
# channel mixing execute.
#   "kernel"  — the stacked-real pipeline on the Hopper kernels (their plain
#               twins for CPU tensors), through the differentiable wrappers
#               of ops/spectral_mm (legdot, dhconv); the port's default
#   "stacked" — the same pipeline on the plain PyTorch twins on any device
#               (the reference the kernels are held against on the card)
#   "xla"     — complex coefficients: float32 einsums for the Legendre
#               contractions and complex_ops' contraction family for the
#               filter (its dhconv on the complex dhconv kernel under
#               complex_ops.enable_pallas_kernels); makani_tpu's default.
# The engines give the same results within the bf16 pass bound.
_COEFF_ENGINE = "kernel"


def set_coeff_engine(name: str):
    global _COEFF_ENGINE
    if name not in ("kernel", "stacked", "xla"):
        raise ValueError(f"unknown coefficient engine {name!r}")
    _COEFF_ENGINE = name


def get_coeff_engine():
    return _COEFF_ENGINE


def _stacked_engine_active():
    """True when the stacked-real pipeline runs: the "kernel" or "stacked"
    engine at a precision the kernels express (makani_tpu/ops/sht.py:110-117)."""
    return _COEFF_ENGINE != "xla" and _coeff_passes() is not None


def _legendre_dot(z, p, contract):
    """(2*mmax, R, K|L) x (mmax, L, K) per-m contraction on the active engine."""
    return spectral_mm.legdot(z, p, contract, _coeff_passes(), plain=_COEFF_ENGINE == "stacked")


def _legendre_einsum(eq, z, p):
    """The complex path's Legendre contraction at the transform precision, on
    every device: "default" rounds both operands to bf16 (products and sums
    in float32), every other mode is float32, as complex_ops' contractions."""
    if _PRECISION == "default":
        z, p = z.to(torch.bfloat16).float(), p.to(torch.bfloat16).float()
    return torch.einsum(eq, z, p)


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

    def _dft(self, x):
        """Real grid (..., nlat, nlon) -> the weighted longitude DFT
        (2*mmax, R, nlat), re rows then im rows."""
        xf = x.float().reshape(-1, self.nlon)                 # (R*nlat, nlon)
        z = torch.matmul(self.dft, xf.T)                       # (2*mmax, R*nlat)
        return z.view(2 * self.mmax, -1, self.nlat).mul_(self.wq)

    def analysis_stacked(self, x):
        """Real grid (..., nlat, nlon) -> m-leading stacked-real coefficients
        (2*mmax, ..., lmax), re rows then im rows."""
        out = _legendre_dot(self._dft(x), self.pct, "k")       # (2*mmax, R, lmax)
        return out.view(2 * self.mmax, *x.shape[:-2], self.lmax)

    def __call__(self, x):
        if _stacked_engine_active():
            z = self.analysis_stacked(x)
            return torch.complex(z[: self.mmax], z[self.mmax:]).movedim(0, -1)
        zs = self._dft(x).view(2, self.mmax, -1, self.nlat)
        o = _legendre_einsum("smrk,mlk->srlm", zs, self.pct)    # (2, R, lmax, mmax)
        out = torch.complex(o[0], o[1]).reshape(*x.shape[:-2], self.lmax, self.mmax)
        return out.contiguous()


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

    def _idft(self, o, batch_shape):
        """(2*mmax, R, nlat) Legendre output -> real grid (..., nlat, nlon)."""
        out = torch.matmul(o.reshape(o.shape[0], -1).T, self.dft)  # (R*nlat, nlon)
        return out.view(*batch_shape, self.nlat, self.nlon)

    def synthesis_stacked(self, z):
        """m-leading stacked-real coefficients (2*mmax, ..., lmax) -> real grid
        (..., nlat, nlon). The twin of RealSHT.analysis_stacked."""
        zf = z.reshape(z.shape[0], -1, z.shape[-1]).contiguous()
        o = _legendre_dot(zf, self.pct, "l")                   # (2*mmax, R, nlat)
        return self._idft(o, z.shape[1:-1])

    def __call__(self, x):
        x = x.to(torch.complex64)
        if _stacked_engine_active():
            z = torch.cat([x.real.movedim(-1, 0), x.imag.movedim(-1, 0)], dim=0)
            return self.synthesis_stacked(z)
        xs = torch.stack([x.real, x.imag]).reshape(2, -1, self.lmax, self.mmax)
        o = _legendre_einsum("srlm,mlk->smrk", xs, self.pct)    # (2, mmax, R, nlat)
        return self._idft(o.reshape(2 * self.mmax, -1, self.nlat), x.shape[:-2])
