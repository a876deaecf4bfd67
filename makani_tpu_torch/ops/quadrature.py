"""Quadrature nodes and weights on [-1, 1] (host-side, float64 numpy).

Copy of makani_tpu/ops/quadrature.py. These feed the SHT Legendre tables and
the quadrature weights applied to the DFT output (Gauss-Legendre via numpy,
Clenshaw-Curtis via Waldvogel's FFT method, Gauss-Lobatto via Newton
iteration on P'_{n-1}). Nodes are returned ascending in [-1, 1].
"""

import numpy as np


def legendre_gauss_nodes_weights(n, a=-1.0, b=1.0):
    """Gauss-Legendre nodes/weights on [a, b]; exact for polys of degree 2n-1."""
    x, w = np.polynomial.legendre.leggauss(n)
    x = (b - a) * 0.5 * x + (b + a) * 0.5
    w = w * (b - a) * 0.5
    return x, w


def clenshaw_curtiss_nodes_weights(n, a=-1.0, b=1.0):
    """Clenshaw-Curtis nodes/weights on [a, b] including the endpoints.

    Nodes are x_j = cos(pi*j/(n-1)), j = n-1..0 (ascending in x). Weights via
    Waldvogel's O(n log n) FFT construction.
    """
    assert n > 1
    x = np.cos(np.linspace(np.pi, 0.0, n))
    if n == 2:
        w = np.array([1.0, 1.0])
    else:
        n1 = n - 1
        N = np.arange(1, n1, 2)
        ln = len(N)
        m = n1 - ln
        v = np.concatenate([2.0 / N / (N - 2.0), np.array([1.0 / N[-1]]), np.zeros(m)])
        v = 0 - v[:-1] - v[-1:0:-1]
        g0 = -np.ones(n1)
        g0[ln] = g0[ln] + n1
        g0[m] = g0[m] + n1
        g = g0 / (n1**2 - 1 + (n1 % 2))
        w = np.fft.ifft(v + g).real
        w = np.concatenate((w, w[:1]))
    x = (b - a) * 0.5 * x + (b + a) * 0.5
    w = w * (b - a) * 0.5
    return x, w


def lobatto_nodes_weights(n, a=-1.0, b=1.0, tol=1e-16, maxiter=100):
    """Gauss-Lobatto-Legendre nodes/weights on [a, b] (includes endpoints)."""
    assert n > 1
    x = np.cos(np.pi * np.arange(n) / (n - 1))
    vdm = np.zeros((n, n))
    xold = 2.0 * np.ones_like(x)
    for _ in range(maxiter):
        xold = x.copy()
        vdm[:, 0] = 1.0
        vdm[:, 1] = x
        for k in range(2, n):
            vdm[:, k] = ((2 * k - 1) * x * vdm[:, k - 1] - (k - 1) * vdm[:, k - 2]) / k
        x = xold - (x * vdm[:, n - 1] - vdm[:, n - 2]) / (n * vdm[:, n - 1])
        if np.max(np.abs(x - xold)) < tol:
            break
    w = 2.0 / ((n * (n - 1)) * (vdm[:, n - 1] ** 2))
    # ascending
    x = x[::-1].copy()
    w = w[::-1].copy()
    x = (b - a) * 0.5 * x + (b + a) * 0.5
    w = w * (b - a) * 0.5
    return x, w


_RULES = {
    "legendre-gauss": legendre_gauss_nodes_weights,
    "clenshaw-curtiss": clenshaw_curtiss_nodes_weights,
    "equiangular": clenshaw_curtiss_nodes_weights,
    "lobatto": lobatto_nodes_weights,
}


def quadrature_nodes_weights(grid, n, a=-1.0, b=1.0):
    """Dispatch by grid name. 'equiangular' uses Clenshaw-Curtis weights on the
    equiangular (endpoint-including) latitude nodes."""
    if grid not in _RULES:
        raise ValueError(f"Unknown quadrature grid {grid}")
    return _RULES[grid](n, a, b)
