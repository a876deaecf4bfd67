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
  - "ortho" normalization, theta in [0, pi] (north pole first, ERA5
    ordering), the Condon-Shortley phase (-1)^m unless csphase=False.

The longitude DFT and its inverse (the grid stage, `_grid_stage`) run at
the precision mode's bf16 passes as makani_tpu runs them on an accelerator
(makani_tpu/ops/sht.py:137-182, stage="grid"), on the gridmm kernel through
spectral_mm.griddot for CUDA tensors on the "kernel" and "xla" engines, and
on its plain twin on any device on the "stacked" engine:
  mode                      forward                  backward (dx = g . T^T)
  "default", "mixed"/"tf32" 1 pass                   1 pass, rounded to bf16
  "split2"                  2 (x rounded to bf16)    2, rounded to bf16
  "mixed2"                  2 (bf16 x at HIGH)       3, rounded to bf16
  "high"                    3 (a bf16 x stays bf16)  3 (bf16 for a bf16 x)
  "highest"                 float32 torch.matmul
On CPU tensors the "kernel" and "xla" engines take the float32 matmul in
every mode, as makani_tpu's CPU branch takes its float32 einsum (:156-160).
The m-leading layouts cost no copy: the kernel stores the analysis output
(and the synthesis cotangent) transposed and reads the synthesis input (and
the analysis cotangent) K-major.

The quadrature weights multiply the DFT output before the Legendre
contraction, so one (mmax, lmax, nlat) table serves both directions of a grid.
Tables are float64 host precomputes stored in float32, one device copy per
(grid, device).

Under a spatial decomposition (parallel/comm's h and w groups, more than one
rank) a 4-D input is the rank's (B, C, lat/h, lon/w) patch, and the
transforms move data as makani_tpu's distributed SHT does
(makani_tpu/ops/sht.py:348-391, 445-483; the reference's
distributed_transpose_azimuth/polar): channels <-> longitude over w, the
longitude DFT, modes <-> channels over w, channels <-> latitude over h, the
Legendre contraction on the rank's m-slice of the table over the full
latitude, and degrees <-> channels over h, so the coefficients are the rank's
(B, C, l/h, m/w) block; synthesis is the mirror. Each move is an explicit
all-to-all (parallel/spmd.distributed_transpose). The stacked-real layout
keeps the "kernel" engine's legmm on the local blocks (M2 = 2 * the rank's
m-slice), and the "xla" engine's complex branch makes the same moves.
"""

from functools import lru_cache

import numpy as np
import torch

from makani_tpu_torch.ops import kernels, spectral_mm
from makani_tpu_torch.ops.dft import irdft_matrices, rdft_matrices
from makani_tpu_torch.ops.legendre import precompute_legpoly
from makani_tpu_torch.ops.quadrature import quadrature_nodes_weights
from makani_tpu_torch.parallel import comm, spmd

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


# The grid stage (the longitude DFT and its inverse) per mode, as makani_tpu's
# transform_einsum(..., stage="grid") runs it on an accelerator: (forward
# passes, backward passes, backward rounded to bf16). The forward's passes
# read only x's bf16 hi part below 3, so x needs no rounding copy: "mixed2"'s
# bf16 x at HIGH is the 2-pass value, its float32 cotangent takes all 3.
_GRID = {"default": (1, 1, True), "tf32": (1, 1, True), "mixed": (1, 1, True),
         "split2": (2, 2, True), "mixed2": (2, 3, True), "high": (3, 3, False)}


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


def _grid_stage(z, dft, dft_t, analysis):
    """The longitude DFT (analysis: real rows z (R, nlon) -> (2*mmax, R), m
    leading, contiguous) or its inverse (z (2*mmax, R) -> (R, nlon)), with
    dft the (2*mmax, nlon) table and dft_t its transpose, at the precision
    mode's passes (_GRID; the module docstring)."""
    mode = _GRID.get(_PRECISION)
    plain = _COEFF_ENGINE == "stacked"
    if mode is None or not (plain or kernels.dispatch(z)):
        # float32: "highest", and every mode on the CPU (the kernel and xla engines)
        return torch.matmul(dft, z.float().T) if analysis else torch.matmul(z.float().T, dft)
    if analysis:
        return spectral_mm.griddot(z, dft_t, dft, *mode, plain=plain, out_t=True)
    return spectral_mm.griddot(z.T, dft, dft_t, *mode, plain=plain)


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
def _get_pct(grid, nlat, lmax, mmax, csphase=True):
    """Shared (mmax, lmax, nlat) Legendre table of a grid (float32)."""
    tq, _ = _theta_weights(grid, nlat)
    pct = precompute_legpoly(mmax, lmax, tq, norm="ortho", csphase=csphase)
    return np.ascontiguousarray(pct, dtype=np.float32)


@lru_cache(maxsize=None)
def _pct_tensor(grid, nlat, lmax, mmax, csphase, device):
    return torch.from_numpy(_get_pct(grid, nlat, lmax, mmax, csphase)).to(device)


@lru_cache(maxsize=None)
def _pct_slice(grid, nlat, lmax, mmax, csphase, device, m0, m1):
    """The m-slice [m0, m1) of a grid's Legendre table, contiguous."""
    return _pct_tensor(grid, nlat, lmax, mmax, csphase, device)[m0:m1].contiguous()


def _dist(x):
    return spmd.spatial_distributed() and x.ndim == 4


class _Splits:
    """The chunks of one transform's dimensions over the h and w groups."""

    def __init__(self, nlat, nlon, lmax, mmax):
        nh, nw = comm.get_size("h"), comm.get_size("w")
        self.lat = spmd.split_shapes(nlat, nh)
        self.lon = spmd.split_shapes(nlon, nw)
        self.l = spmd.split_shapes(lmax, nh)
        self.m = spmd.split_shapes(mmax, nw)
        self.nh, self.nw = nh, nw
        self.lat0, self.nlat_local = spmd.patch(nlat, "h")
        self.m0, self.ml = spmd.patch(mmax, "w")


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


@lru_cache(maxsize=None)
def _transposed(table_fn, nlon, mmax, device):
    """The (nlon, 2*mmax) transpose of a DFT table, contiguous: the kernel's
    table of the analysis and the synthesis backward."""
    return table_fn(nlon, mmax, device).T.contiguous()


class RealSHT:
    """Analysis: real (..., nlat, nlon) -> complex (..., lmax, mmax)."""

    def __init__(self, nlat, nlon, lmax=None, mmax=None, grid="lobatto", csphase=True,
                 device="cpu"):
        self.nlat = nlat
        self.nlon = nlon
        self.grid = grid
        self.lmax = lmax or self.nlat
        self.mmax = mmax or self.nlon // 2 + 1
        self.device = torch.device(device)
        _, wq = _theta_weights(grid, nlat)
        self.wq = torch.as_tensor(wq, dtype=torch.float32).to(self.device)
        self.csphase = csphase
        self.pct = _pct_tensor(grid, nlat, self.lmax, self.mmax, csphase, self.device)
        self.dft = _rdft_tensor(nlon, self.mmax, self.device)
        self.dft_t = _transposed(_rdft_tensor, nlon, self.mmax, self.device)

    def _dft(self, x):
        """Real grid (..., nlat, nlon) -> the weighted longitude DFT
        (2*mmax, R, nlat), re rows then im rows. A bf16 (AMP) x stays bf16
        into the kernel."""
        xf = x.reshape(-1, self.nlon)                                # (R*nlat, nlon)
        if xf.dtype != torch.bfloat16:
            xf = xf.float()
        z = _grid_stage(xf, self.dft, self.dft_t, True)              # (2*mmax, R*nlat)
        return z.view(2 * self.mmax, -1, self.nlat).mul_(self.wq)

    def analysis_stacked(self, x):
        """Real grid (..., nlat, nlon) -> m-leading stacked-real coefficients
        (2*mmax, ..., lmax), re rows then im rows. Distributed: the rank's
        patch (B, C, lat/h, lon/w) -> (2*ml, B, C, l/h), ml its m-slice."""
        if _dist(x):
            z = self._analysis_dist(x, stacked=True)
            return z.reshape(-1, *z.shape[2:])
        out = _legendre_dot(self._dft(x), self.pct, "k")       # (2*mmax, R, lmax)
        return out.view(2 * self.mmax, *x.shape[:-2], self.lmax)

    def _analysis_dist(self, x, stacked):
        """The rank's patch (B, C, lat/h, lon/w) -> (2, ml, B, C, l/h)."""
        sp = _Splits(self.nlat, self.nlon, self.lmax, self.mmax)
        B, C = x.shape[:2]
        c_w, c_h = spmd.split_shapes(C, sp.nw), spmd.split_shapes(C, sp.nh)
        # azimuth: channels over w, longitude local
        x = spmd.distributed_transpose(x.float(), 1, 3, "w", c_w, sp.lon)           # (B, C/w, lat/h, nlon)
        hl = x.shape[2]
        z = _grid_stage(x.reshape(-1, self.nlon), self.dft, self.dft_t, True)  # (2*mmax, B*C/w*lat/h)
        wq = self.wq[sp.lat0: sp.lat0 + sp.nlat_local]
        z = z.view(2, self.mmax, B, x.shape[1], hl).mul_(wq)
        # modes over w, channels local; then channels over h, latitude local
        z = spmd.distributed_transpose(z, 1, 3, "w", sp.m, c_w)                     # (2, ml, B, C, lat/h)
        z = spmd.distributed_transpose(z, 3, 4, "h", c_h, sp.lat)                   # (2, ml, B, C/h, nlat)
        pct = _pct_slice(self.grid, self.nlat, self.lmax, self.mmax, self.csphase,
                         self.device, sp.m0, sp.m0 + sp.ml)
        ch = z.shape[3]
        if stacked:
            o = _legendre_dot(z.reshape(2 * sp.ml, B * ch, self.nlat).contiguous(), pct, "k")
        else:
            o = _legendre_einsum("smrk,mlk->smrl", z.reshape(2, sp.ml, B * ch, self.nlat), pct)
        o = o.reshape(2, sp.ml, B, ch, self.lmax)
        # degrees over h, channels local
        return spmd.distributed_transpose(o, 4, 3, "h", sp.l, c_h).contiguous()     # (2, ml, B, C, l/h)

    def __call__(self, x):
        if _dist(x):
            o = self._analysis_dist(x, stacked=_stacked_engine_active())
            return torch.complex(o[0], o[1]).permute(1, 2, 3, 0).contiguous()
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
        self.nlat = nlat
        self.nlon = nlon
        self.grid = grid
        self.lmax = lmax or self.nlat
        self.mmax = mmax or self.nlon // 2 + 1
        self.device = torch.device(device)
        # ortho normalization: the synthesis table equals the analysis table
        self.csphase = csphase
        self.pct = _pct_tensor(grid, nlat, self.lmax, self.mmax, csphase, self.device)
        self.dft = _irdft_tensor(nlon, self.mmax, self.device)
        self.dft_t = _transposed(_irdft_tensor, nlon, self.mmax, self.device)

    def _idft(self, o, batch_shape):
        """(2*mmax, R, nlat) Legendre output -> real grid (..., nlat, nlon)."""
        out = _grid_stage(o.reshape(o.shape[0], -1), self.dft, self.dft_t, False)  # (R*nlat, nlon)
        return out.view(*batch_shape, self.nlat, self.nlon)

    def synthesis_stacked(self, z):
        """m-leading stacked-real coefficients (2*mmax, ..., lmax) -> real grid
        (..., nlat, nlon). The twin of RealSHT.analysis_stacked; distributed:
        (2*ml, B, C, l/h) -> the rank's patch (B, C, lat/h, lon/w)."""
        if spmd.spatial_distributed() and z.ndim == 4:
            return self._synthesis_dist(z.view(2, -1, *z.shape[1:]), stacked=True)
        zf = z.reshape(z.shape[0], -1, z.shape[-1]).contiguous()
        o = _legendre_dot(zf, self.pct, "l")                   # (2*mmax, R, nlat)
        return self._idft(o, z.shape[1:-1])

    def _synthesis_dist(self, z, stacked):
        """(2, ml, B, C, l/h) -> the rank's patch (B, C, lat/h, lon/w)."""
        sp = _Splits(self.nlat, self.nlon, self.lmax, self.mmax)
        B, C = z.shape[2:4]
        c_w, c_h = spmd.split_shapes(C, sp.nw), spmd.split_shapes(C, sp.nh)
        # channels over h, degrees local
        z = spmd.distributed_transpose(z.float(), 3, 4, "h", c_h, sp.l)              # (2, ml, B, C/h, lmax)
        ch = z.shape[3]
        pct = _pct_slice(self.grid, self.nlat, self.lmax, self.mmax, self.csphase,
                         self.device, sp.m0, sp.m0 + sp.ml)
        if stacked:
            o = _legendre_dot(z.reshape(2 * sp.ml, B * ch, self.lmax).contiguous(), pct, "l")
        else:
            o = _legendre_einsum("smrl,mlk->smrk", z.reshape(2, sp.ml, B * ch, self.lmax), pct)
        o = o.reshape(2, sp.ml, B, ch, self.nlat)
        # latitude over h, channels local; then channels over w, modes local
        o = spmd.distributed_transpose(o, 4, 3, "h", sp.lat, c_h)                   # (2, ml, B, C, lat/h)
        o = spmd.distributed_transpose(o, 3, 1, "w", c_w, sp.m)                     # (2, mmax, B, C/w, lat/h)
        cw, hl = o.shape[3], o.shape[4]
        out = _grid_stage(o.reshape(2 * self.mmax, -1), self.dft, self.dft_t, False)  # (B*C/w*lat/h, nlon)
        out = out.view(B, cw, hl, self.nlon)
        # longitude over w, channels local
        return spmd.distributed_transpose(out, 3, 1, "w", sp.lon, c_w)              # (B, C, lat/h, lon/w)

    def __call__(self, x):
        x = x.to(torch.complex64)
        if _dist(x):
            z = torch.stack([x.real, x.imag]).permute(0, 4, 1, 2, 3)   # (2, ml, B, C, l/h)
            return self._synthesis_dist(z, stacked=_stacked_engine_active())
        if _stacked_engine_active():
            z = torch.cat([x.real.movedim(-1, 0), x.imag.movedim(-1, 0)], dim=0)
            return self.synthesis_stacked(z)
        xs = torch.stack([x.real, x.imag]).reshape(2, -1, self.lmax, self.mmax)
        o = _legendre_einsum("srlm,mlk->smrk", xs, self.pct)    # (2, mmax, R, nlat)
        return self._idft(o.reshape(2 * self.mmax, -1, self.nlat), x.shape[:-2])
