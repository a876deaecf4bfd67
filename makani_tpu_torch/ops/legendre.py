"""Normalized associated Legendre polynomial tables for the SHT.

Copy of makani_tpu/ops/legendre.py. Computes P-hat_l^m(cos theta) with
"ortho" normalization such that Y_lm = P-hat_l^m(cos theta) * exp(i m phi) is
an orthonormal basis on S^2, including the Condon-Shortley phase (-1)^m.
Stable l-recursion per m. The (mmax, lmax, nlat) table is the operand of the
Legendre contraction kernel (ops/spectral_mm.legmm).
"""

import numpy as np


def precompute_legpoly(mmax, lmax, t, norm="ortho", inverse=False, csphase=True):
    """Associated Legendre table.

    Parameters
    ----------
    mmax, lmax : int — number of azimuthal / total wavenumbers retained
    t : (nlat,) array of colatitudes theta in [0, pi]
    norm : "ortho" | "schmidt" | "4pi"
    inverse : apply inverse normalization factor (for synthesis)
    csphase : include Condon-Shortley phase (-1)^m

    Returns
    -------
    (mmax, lmax, nlat) float64 array; entry [m, l, k] = P-hat_l^m(cos t_k),
    zero for l < m.
    """
    nmax = max(mmax, lmax)
    t = np.asarray(t, dtype=np.float64)
    nlat = t.shape[0]
    x = np.cos(t)
    s = np.sin(t)  # sin(theta) >= 0 on [0, pi]

    pct = np.zeros((nmax, nmax, nlat), dtype=np.float64)

    norm_factor = 1.0 if norm == "ortho" else np.sqrt(4 * np.pi)
    norm_factor = 1.0 / norm_factor if inverse else norm_factor

    # P-hat_0^0 = 1/sqrt(4 pi)
    pct[0, 0, :] = norm_factor / np.sqrt(4.0 * np.pi)

    # diagonal P_m^m and first superdiagonal P_{m+1}^m
    for l in range(1, nmax):
        # P_{l}^{l} = sqrt((2l+1)/(2l)) * sin(theta) * P_{l-1}^{l-1}
        pct[l, l, :] = np.sqrt((2.0 * l + 1.0) / (2.0 * l)) * s * pct[l - 1, l - 1, :]
        # P_{l}^{l-1} = sqrt(2l+1) * cos(theta) * P_{l-1}^{l-1}
        pct[l - 1, l, :] = np.sqrt(2.0 * l + 1.0) * x * pct[l - 1, l - 1, :]

    # remaining entries via the stable three-term recursion in l
    for l in range(2, nmax):
        for m in range(0, l - 1):
            a = np.sqrt((4.0 * l * l - 1.0) / (l * l - m * m))
            b = np.sqrt(((l - 1.0) ** 2 - m * m) / (4.0 * (l - 1.0) ** 2 - 1.0))
            pct[m, l, :] = a * (x * pct[m, l - 1, :] - b * pct[m, l - 2, :])

    if norm == "schmidt":
        for l in range(nmax):
            if inverse:
                pct[:, l, :] = pct[:, l, :] * np.sqrt(2.0 * l + 1.0)
            else:
                pct[:, l, :] = pct[:, l, :] / np.sqrt(2.0 * l + 1.0)

    pct = pct[:mmax, :lmax]

    if csphase:
        for m in range(1, mmax, 2):
            pct[m] = -pct[m]

    return pct
