"""Plain float32 PyTorch reference of the SFNO train step (Bonev et al.,
"Spherical Fourier Neural Operators", ICML 2023, as makani configures it):
encoder, blocks of spherical filter (analysis, per-degree complex channel
mix "dhconv", synthesis), instance norm, GELU, MLP, instance norm and a
linear outer skip, decoder and the big skip; the absolute squared
geometric l2 loss; float32 Adam.

It works out again everything the program derives: the quadratures
(Clenshaw-Curtis on the equiangular grid by its closed form,
Gauss-Legendre from numpy), the orthonormal associated Legendre tables
with the Condon-Shortley phase, and the longitude transform, taken here by
cuFFT (torch.fft) where the program runs a DFT product. Under
`precision="fp8"` every product's operands (the Legendre contractions, the
complex channel mix, the 1x1 mixes, the FFTs' inputs) are rounded to
float8 e4m3: the control.

Also here: what one step of this model asks of each of the program's
kernels (`kernel_work`) and the model's matrix products (`model_flops`),
from the configuration's shapes.
"""

import math

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from benchmark.reference.common import adam, conv1x1, gelu, instance_norm, quantizer

SUPPORTED = dict(nettype="SFNO", filter_type="linear", operator_type="dhconv", separable=False,
                 normalization_layer="instance_norm", use_mlp=True, pos_embed="none",
                 activation_function="gelu", n_history=0, target="default",
                 loss="absolute squared geometric l2", add_grid=False, add_zenith=False,
                 add_orography=False, add_landmask=False, hard_thresholding_fraction=1.0)


def check_supported(params):
    for key, want in SUPPORTED.items():
        if params.get(key, want) != want:
            raise NotImplementedError(f"the SFNO reference has {key}={want!r}, the config "
                                      f"{params.get(key)!r}")


def shapes(params):
    """The sizes the model runs at: channels, embedding, grids and modes."""
    nlat, nlon = int(params["img_shape_x"]), int(params["img_shape_y"])
    sf = params["scale_factor"]
    h, w = int(nlat // sf), int(nlon // sf)
    return dict(C=len(params["in_channels"]), E=int(params["embed_dim"]),
                H=int(params["embed_dim"] * params["mlp_ratio"]), depth=int(params["num_layers"]),
                full=(nlat, nlon), inner=(h, w), L=h, M=w // 2 + 1,
                full_grid=params["model_grid_type"], inner_grid=params["sht_grid_type"])


def parameters(params):
    """[(name, shape, init)] under the program's state-dict names."""
    s = shapes(params)
    C, E, H, L = s["C"], s["E"], s["H"], s["L"]

    def normal(std):
        return ("normal", std)

    spec = [("model.residual_transform", (C, C), normal(math.sqrt(0.5 / C))),
            ("model.encoder.fwd_0.weight", (E, C), normal(math.sqrt(2.0 / C))),
            ("model.encoder.fwd_0.bias", (E,), ("zeros",)),
            ("model.encoder.out.weight", (E, E), normal(math.sqrt(1.0 / E)))]
    for i in range(s["depth"]):
        b = f"model.blocks.{i}."
        spec += [(b + "filter_layer.filter.weight", (2, L, E, E), normal(math.sqrt(2.0 / E))),
                 (b + "norm0.weight", (E,), ("ones",)), (b + "norm0.bias", (E,), ("zeros",)),
                 (b + "mlp.fc1.weight", (H, E), normal(math.sqrt(2.0 / E))),
                 (b + "mlp.fc1.bias", (H,), ("zeros",)),
                 (b + "mlp.fc2.weight", (E, H), normal(math.sqrt(0.5 / H))),
                 (b + "mlp.fc2.bias", (E,), ("zeros",)),
                 (b + "norm1.weight", (E,), ("ones",)), (b + "norm1.bias", (E,), ("zeros",)),
                 (b + "outer_skip.weight", (E, E), normal(math.sqrt(0.5 / E)))]
    spec += [("model.decoder.fwd_0.weight", (E, E), normal(math.sqrt(2.0 / E))),
             ("model.decoder.fwd_0.bias", (E,), ("zeros",)),
             ("model.decoder.out.weight", (C, E), normal(math.sqrt(0.5 / E)))]
    return spec


# --- quadratures and Legendre tables (float64, host) ---

def clenshaw_curtis(n):
    """Colatitudes j pi / (n - 1), north first, and the Clenshaw-Curtis
    weights by their closed form (they sum to 2)."""
    N = n - 1
    theta = np.pi * np.arange(n) / N
    k = np.arange(1, N // 2 + 1)
    b = np.where(2 * k == N, 1.0, 2.0)
    w = 1.0 - (b / (4.0 * k * k - 1.0) * np.cos(2.0 * np.outer(theta, k))).sum(axis=1)
    c = np.full(n, 2.0)
    c[0] = c[-1] = 1.0
    return theta, c * w / N


def gauss_legendre(n):
    """Colatitudes of the Gauss-Legendre nodes, north first, and weights."""
    x, w = np.polynomial.legendre.leggauss(n)
    return np.arccos(x)[::-1].copy(), w[::-1].copy()


def legendre_table(mmax, lmax, theta):
    """(mmax, lmax, nlat) orthonormal associated Legendre functions
    P_l^m(cos theta) with the Condon-Shortley phase; zero for l < m."""
    n = max(mmax, lmax)
    x, s = np.cos(theta), np.sin(theta)
    p = np.zeros((n, n, theta.size))
    p[0, 0] = 1.0 / np.sqrt(4.0 * np.pi)
    for l in range(1, n):
        p[l, l] = np.sqrt((2.0 * l + 1.0) / (2.0 * l)) * s * p[l - 1, l - 1]
        p[l - 1, l] = np.sqrt(2.0 * l + 1.0) * x * p[l - 1, l - 1]
    for l in range(2, n):
        m = np.arange(l - 1)[:, None]
        a = np.sqrt((4.0 * l * l - 1.0) / (l * l - m * m))
        b = np.sqrt(((l - 1.0) ** 2 - m * m) / (4.0 * (l - 1.0) ** 2 - 1.0))
        p[: l - 1, l] = a * (x * p[: l - 1, l - 1] - b * p[: l - 1, l - 2])
    p[1::2] *= -1.0
    return p[:mmax, :lmax]


class Grid:
    """One grid's analysis and synthesis at lmax L, mmax M."""

    def __init__(self, kind, nlat, nlon, L, M, device):
        theta, w = (clenshaw_curtis if kind == "equiangular" else gauss_legendre)(nlat)
        self.nlat, self.nlon, self.L, self.M = nlat, nlon, L, M
        self.wq = torch.tensor(w, dtype=torch.float32, device=device)
        self.p = torch.tensor(legendre_table(M, L, theta), dtype=torch.float32, device=device)

    def analysis(self, x, q):
        """(B, C, nlat, nlon) real -> (B, C, L, M) complex."""
        X = torch.fft.rfft(q(x), dim=-1)[..., : self.M] * (2.0 * math.pi / self.nlon)
        X = X * self.wq[:, None]
        B, C = x.shape[:2]
        z = torch.view_as_real(X.permute(3, 0, 1, 2).contiguous())          # (M, B, C, K, 2)
        z = z.permute(0, 1, 2, 4, 3).reshape(self.M, B * C * 2, self.nlat)
        o = torch.bmm(q(z), q(self.p).transpose(1, 2))                      # (M, B*C*2, L)
        o = o.view(self.M, B, C, 2, self.L).permute(1, 2, 4, 0, 3).contiguous()
        return torch.view_as_complex(o)

    def synthesis(self, c, q):
        """(B, C, L, M) complex -> (B, C, nlat, nlon) real."""
        B, C = c.shape[:2]
        z = torch.view_as_real(c).permute(3, 0, 1, 4, 2).reshape(self.M, B * C * 2, self.L)
        o = torch.bmm(q(z), q(self.p))                                      # (M, B*C*2, K)
        o = o.view(self.M, B, C, 2, self.nlat).permute(1, 2, 4, 0, 3).contiguous()
        Y = torch.view_as_complex(o)                                        # (B, C, K, M)
        Y = torch.nn.functional.pad(Y, (0, self.nlon // 2 + 1 - self.M))
        return torch.fft.irfft(q(Y), n=self.nlon, dim=-1, norm="forward")


class SFNO:
    """The reference model at `params`' shapes on `device`, in `precision`
    ("float32", or "fp8" for the control)."""

    def __init__(self, params, device, precision="float32"):
        check_supported(params)
        s = self.s = shapes(params)
        self.q = quantizer(precision)
        self.full = Grid(s["full_grid"], *s["full"], s["L"], s["M"], device)
        self.inner = Grid(s["inner_grid"], *s["inner"], s["L"], s["M"], device)
        nlat, nlon = s["full"]
        # the loss's quadrature: sin(theta) on the equiangular rows, summing to 1
        jac = np.clip(np.sin(np.linspace(0.0, np.pi, nlat)), 0.0, None)
        qw = np.tile(jac[:, None], (1, nlon))
        self.loss_weights = torch.tensor(qw / qw.sum(), dtype=torch.float32, device=device)

    def block(self, W, i, x):
        q, b = self.q, f"model.blocks.{i}."
        fwd = self.full if i == 0 else self.inner
        inv = self.full if i == self.s["depth"] - 1 else self.inner
        z = fwd.analysis(x, q)
        residual = inv.synthesis(z, q) if fwd is not inv else x
        w = W[b + "filter_layer.filter.weight"]                             # (2, L, C, O)
        o = torch.einsum("bclm,lco->bolm", q(z), q(torch.complex(w[0], w[1])))
        y = inv.synthesis(o, q)
        y = gelu(instance_norm(y, W[b + "norm0.weight"], W[b + "norm0.bias"]))
        y = gelu(conv1x1(y, W[b + "mlp.fc1.weight"], W[b + "mlp.fc1.bias"], q))
        y = conv1x1(y, W[b + "mlp.fc2.weight"], W[b + "mlp.fc2.bias"], q)
        y = instance_norm(y, W[b + "norm1.weight"], W[b + "norm1.bias"])
        return y + conv1x1(residual, W[b + "outer_skip.weight"], None, q)

    def forward(self, W, x, recompute=False):
        """The prediction of input x (B, C, nlat, nlon) under weights W;
        `recompute` keeps only each block's input for backward."""
        q = self.q

        def run(fn, *args):
            return checkpoint(fn, *args, use_reentrant=False) if recompute else fn(*args)

        def encoder(x):
            h = gelu(conv1x1(x, W["model.encoder.fwd_0.weight"], W["model.encoder.fwd_0.bias"], q))
            return conv1x1(h, W["model.encoder.out.weight"], None, q)

        def decoder(h):
            h = gelu(conv1x1(h, W["model.decoder.fwd_0.weight"], W["model.decoder.fwd_0.bias"], q))
            return conv1x1(h, W["model.decoder.out.weight"], None, q)

        h = run(encoder, x)
        for i in range(self.s["depth"]):
            h = run(lambda t, i=i: self.block(W, i, t), h)
        return run(decoder, h) + conv1x1(x, W["model.residual_transform"], None, q)

    def loss(self, pred, tar):
        """Channel mean of the quadrature-weighted squared error, summed over
        the batch."""
        err = ((pred - tar) ** 2 * self.loss_weights).sum(dim=(-2, -1))
        return err.mean(dim=1).sum()

    def train_steps(self, W, batches, lr, b1, b2, eps):
        """Adam steps from weights W (float32, not modified) on `batches`
        [(inp, tar)]; returns the losses, the first gradient's norm per leaf
        and the norm of each leaf's change over all the steps."""
        params = {k: v.detach().clone().requires_grad_(True) for k, v in W.items()}
        state, losses, g1 = {}, [], None
        for inp, tar in batches:
            loss = self.loss(self.forward(params, inp, recompute=True), tar)
            grads = torch.autograd.grad(loss, list(params.values()))
            grads = dict(zip(params, grads))
            if g1 is None:
                g1 = {k: float(g.norm()) for k, g in grads.items()}
            losses.append(float(loss.detach()))
            adam(params, grads, state, lr, b1, b2, eps)
            del grads, loss
        change = {k: float((p.detach() - W[k]).norm()) for k, p in params.items()}
        return losses, g1, change


# the reference model of this family, as the harness names it
Model = SFNO


# --- work counts from the shapes ---

def _transforms(s):
    """[(grid, kind)] of the spherical transforms one forward runs: each
    block's analysis and synthesis, and the synthesis of the analysed input
    on the output grid where a block changes grids."""
    depth, out = s["depth"], []
    for i in range(depth):
        fwd = "full" if i == 0 else "inner"
        inv = "full" if i == depth - 1 else "inner"
        out.append((fwd, "analysis"))
        out += [(inv, "synthesis")] * (2 if fwd != inv else 1)
    return out


def kernel_work(params, batch, train):
    """{kernel: [(launches, bytes, operations) of each launch shape]} one
    step asks of the program's kernels under bf16 AMP: bytes count each
    input once and each output once in the dtype the path hands the
    kernel; operations are 2*M*N*K of the logical product (8 real
    operations a complex multiply-add), once, whatever the kernel's
    passes."""
    s = shapes(params)
    E, L, M, M2 = s["E"], s["L"], s["M"], 2 * s["M"]
    R = batch * E
    grids = {"full": s["full"], "inner": s["inner"]}
    work = {}

    def add(kernel, launches, nbytes, ops):
        work.setdefault(kernel, []).append((launches, float(nbytes), float(ops)))

    passes = 2 if train else 1
    for grid, kind in _transforms(s):
        K, nlon = grids[grid]
        rows = R * K
        # Legendre: z (2M, R, K|L) f32 x table (M, L, K) f32 -> (2M, R, L|K)
        # f32; its transpose in backward moves as much
        add("legmm", passes, 4 * (M2 * R * K + M * L * K + M2 * R * L), 2 * M2 * R * K * L)
        # longitude DFT: rows x nlon by the (nlon, 2M) f32 table; a block's
        # input is bf16 and the Legendre side f32, and the cotangent of a
        # bf16 input comes back bf16, so backward moves as much as forward
        grid_side = 2 * rows * nlon if kind == "analysis" else 4 * rows * nlon
        add("gridmm", passes, grid_side + 4 * nlon * M2 + 4 * M2 * rows, 2 * rows * nlon * M2)
    # dhconv: x (2, B, L, C, M), w (2, L, C, O) -> (2, B, L, O, M), f32;
    # dx and dw alike
    mix = 4 * (2 * 2 * batch * L * E * M + 2 * L * E * E)
    add("dhconv_mm", s["depth"] * passes, mix, 8 * batch * L * M * E * E)
    if train:
        add("dhconv_dw", s["depth"], mix, 8 * batch * L * M * E * E)
        n = sum(math.prod(shape) for _, shape, _ in parameters(params))
        # p and g f32 read, p written; the moments read and written
        moment = 2 if params.get("optimizer_moment_dtype") in ("bfloat16", "bf16") else 4
        add("fused_adam", 1, n * (4 + 4 + 4 + 4 * moment), 0.0)
    # GELU on bf16, forward x -> y (4 bytes an element) and backward
    # (x, g) -> dx (6): the encoder's and the decoder's hidden layer at full
    # resolution, and each block's after norm0 (E channels) and in its MLP
    # (H), on the block's output grid
    acts = [E * math.prod(s["full"])] * 2
    for i in range(s["depth"]):
        pts = math.prod(s["full"] if i == s["depth"] - 1 else s["inner"])
        acts += [E * pts, s["H"] * pts]
    for elems in acts:
        add("gelu", 1, 4 * batch * elems, 0.0)
        if train:
            add("gelu", 1, 6 * batch * elems, 0.0)
    return work


def model_flops(params, batch, train):
    """The model's matrix products a step as the algorithm writes them: the
    longitude DFTs and the Legendre transforms as dense products, the
    complex channel mix (8 real operations a complex multiply-add), the 1x1
    mixes, the encoder, the decoder and the big skip; three times the
    forward for a train step."""
    s = shapes(params)
    E, H, C, L, M2 = s["E"], s["H"], s["C"], s["L"], 2 * s["M"]
    grids = {"full": s["full"], "inner": s["inner"]}
    f = 0.0
    for grid, _ in _transforms(s):
        K, nlon = grids[grid]
        f += 2 * E * K * nlon * M2 + 2 * M2 * E * K * L
    f += s["depth"] * 8 * L * s["M"] * E * E
    for i in range(s["depth"]):
        pts = math.prod(s["full"] if i == s["depth"] - 1 else s["inner"])
        f += 2 * pts * (2 * E * H + E * E)
    pts = math.prod(s["full"])
    f += 2 * pts * (C * E + E * E) + 2 * pts * (E * E + E * C) + 2 * pts * C * C
    return f * batch * (3 if train else 1)
