"""Tensor-factorized spectral weights (dense, CP, Tucker, TT).

Counterpart of makani_tpu/models/common/factorizations.py (:27-160). The
factors are stored as real pairs ``(..., 2)`` under makani_tpu's names
(``factors_dense``, ``lambda``, ``factor_<d>``, ``core``, ``core_<d>``); the
full complex weight is rebuilt from them on every call and fed to the
operator's contraction (complex_ops.get_contract_fun), as in makani_tpu. So a
factorized dhconv filter reaches `contract_dhconv`, which runs the complex
dhconv kernel (csrc/dhconv_complex.cu) on the card under
`complex_ops.enable_pallas_kernels`.
"""

import math

import torch
from torch import nn

from makani_tpu_torch.models.common.spectral_convolution import scale_residual
from makani_tpu_torch.ops.complex_ops import get_contract_fun, view_as_complex
from makani_tpu_torch.parallel import spmd

_LETTERS = "abcdefgh"
_RANK_LETTERS = "ijklmnop"


def _kind(factorization):
    kind = factorization.lower()
    for name, aliases in (("dense", ("complexdense", "dense", "none")),
                          ("cp", ("complexcp", "cp")),
                          ("tucker", ("complextucker", "tucker")),
                          ("tt", ("complextt", "tt"))):
        if kind in aliases:
            return name
    raise ValueError(f"Unsupported factorization {factorization}")


class FactorizedWeight(nn.Module):
    """The factors of a complex tensor of `shape`; calling it rebuilds the
    full complex tensor. `rank`: an int is the rank itself, a float the
    fraction of the dense tensor's parameters (makani_tpu's convention:
    int(rank * prod(shape) / per-rank parameters), at least 1)."""

    def __init__(self, shape, factorization="ComplexDense", rank=0.2, std=1.0, device="cpu",
                 generator=None):
        super().__init__()
        self.shape = tuple(int(s) for s in shape)
        self.kind = _kind(factorization)
        ndim = len(self.shape)

        def pair(name, shape, scale):
            self.register_parameter(name, nn.Parameter(
                scale * torch.randn((*shape, 2), device=device, generator=generator)))

        if self.kind == "dense":
            pair("factors_dense", self.shape, std)
            return
        r = self._rank_int(rank)
        if self.kind == "cp":
            pair("lambda", (r,), std)
            for d, s in enumerate(self.shape):
                pair(f"factor_{d}", (s, r), 1.0)
        elif self.kind == "tucker":
            self.ranks = [min(r, s) for s in self.shape]
            pair("core", self.ranks, std)
            for d, (s, rr) in enumerate(zip(self.shape, self.ranks)):
                pair(f"factor_{d}", (s, rr), 1.0)
        else:
            ranks = [1] + [r] * (ndim - 1) + [1]
            for d, s in enumerate(self.shape):
                pair(f"core_{d}", (ranks[d], s, ranks[d + 1]), std ** (1.0 / ndim))

    def _rank_int(self, rank):
        if isinstance(rank, int):
            return max(1, rank)
        n_dense = int(math.prod(self.shape))
        per_rank = sum(self.shape) + (1 if self.kind == "tucker" else 0)
        return max(1, int(rank * n_dense / per_rank))

    def _c(self, name):
        return view_as_complex(getattr(self, name))

    def forward(self):
        ndim = len(self.shape)
        letters = _LETTERS[:ndim]
        if self.kind == "dense":
            return self._c("factors_dense")
        if self.kind == "cp":
            # weight = sum_r lambda_r prod_d factor_d[i_d, r]
            eq = ",".join(f"{c}r" for c in letters) + ",r->" + letters
            return torch.einsum(eq, *(self._c(f"factor_{d}") for d in range(ndim)),
                                self._c("lambda"))
        if self.kind == "tucker":
            rl = _RANK_LETTERS[:ndim]
            eq = rl + "," + ",".join(f"{a}{b}" for a, b in zip(letters, rl)) + "->" + letters
            return torch.einsum(eq, self._c("core"),
                                *(self._c(f"factor_{d}") for d in range(ndim)))
        out = self._c("core_0")                                    # (1, s0, r1)
        for d in range(1, ndim):
            out = torch.einsum("...a,abc->...bc", out, self._c(f"core_{d}"))
        return out[0, ..., 0]


class FactorizedSpectralConv(nn.Module):
    """SpectralConv with a factorized weight (makani_tpu's
    FactorizedSpectralConv): the analysis transform in float32, the operator's
    contraction with the rebuilt weight, the synthesis. forward returns
    ``(out, residual)`` as SpectralConv does; bias "constant" adds
    ``bias_const (1, O, 1, 1)``."""

    def __init__(self, forward_transform, inverse_transform, in_channels, out_channels,
                 operator_type="diagonal", rank=0.2, factorization="ComplexDense",
                 separable=False, bias=False, gain=1.0, device="cpu", generator=None):
        super().__init__()
        self.forward_transform = forward_transform
        self.inverse_transform = inverse_transform
        self.contract = get_contract_fun(operator_type, separable)
        self.diagonal = operator_type == "diagonal"
        fwd_t, inv_t = forward_transform, inverse_transform
        self.scale_residual = scale_residual(fwd_t, inv_t)
        shape = [in_channels] + ([] if separable else [out_channels])
        shape += [inv_t.lmax, inv_t.mmax] if operator_type == "diagonal" else [inv_t.lmax]
        self.weight = FactorizedWeight(shape, factorization=factorization, rank=rank,
                                       std=math.sqrt(gain / float(in_channels)), device=device,
                                       generator=generator)
        self.bias_mode = bias
        if bias == "constant":
            self.bias_const = nn.Parameter(torch.zeros(1, out_channels, 1, 1, device=device))

    def forward(self, x):
        fwd_t, inv_t = self.forward_transform, self.inverse_transform
        dtype = x.dtype
        residual = x
        x = fwd_t(x.float())
        if self.scale_residual:
            residual = inv_t(x).to(dtype)
        w = self.weight()
        if spmd.spatial_distributed():
            # the rank's (l/h[, m/w]) block of the rebuilt weight
            w = spmd.coefficient_block(w, self.diagonal)
        x = inv_t(self.contract(x, w))
        if self.bias_mode == "constant":
            x = x + self.bias_const
        return x.to(dtype), residual
