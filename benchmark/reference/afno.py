"""Plain float32 PyTorch reference of the AFNO v2 forecast step (FourCastNet,
Pathak et al. 2022, arXiv:2202.11214, as makani configures its v2 filter):
the 8 x 8 patch embedding and position embedding, blocks of instance norm,
the adaptive Fourier filter (orthonormal rfft2, a blockwise complex
two-layer MLP with a ReLU on both parts, softshrink, irfft2, its bias and
its input added), the identity skip, instance norm and the MLP, then the
1x1 head and the pixel shuffle. Under `precision="fp8"` the operands of
every product (and the FFTs' inputs) are rounded to float8 e4m3: the
control.

Also here: what one forecast step asks of the program's GELU kernels
(`kernel_work`) and the model's matrix products (`model_flops`).
"""

import math

import torch

from benchmark.reference.common import gelu, instance_norm, quantizer

SUPPORTED = dict(nettype="AFNO", normalization_layer="instance_norm", skip_fno="identity",
                 nested_skip_fno=True, hard_thresholding_fraction=1.0, n_history=0,
                 target="default", add_grid=False, add_zenith=False, add_orography=False,
                 add_landmask=False, activation_function="gelu")


def check_supported(params):
    for key, want in SUPPORTED.items():
        if params.get(key, want) != want:
            raise NotImplementedError(f"the AFNO reference has {key}={want!r}, the config "
                                      f"{params.get(key)!r}")


def shapes(params):
    ph, pw = params["patch_size"]
    nlat, nlon = int(params["crop_size_x"]), int(params["crop_size_y"])
    E = int(params["embed_dim"])
    return dict(C=len(params["in_channels"]), E=E, H=int(E * params.get("mlp_ratio", 4.0)),
                depth=int(params["num_layers"]), nb=int(params["num_blocks"]),
                patch=(ph, pw), image=(nlat, nlon), grid=(nlat // ph, nlon // pw))


def parameters(params):
    """[(name, shape, init)] under the program's state-dict names."""
    s = shapes(params)
    C, E, H, nb = s["C"], s["E"], s["H"], s["nb"]
    ph, pw = s["patch"]
    bs = E // nb
    n = s["grid"][0] * s["grid"][1]
    spec = [("model.pos_embed", (1, E, n), ("normal", 0.02)),
            ("model.head_weight", (C * ph * pw, E), ("normal", 0.02)),
            ("model.patch_embed.weight", (E, C, ph, pw), ("normal", math.sqrt(1.0 / (C * ph * pw)))),
            ("model.patch_embed.bias", (E,), ("zeros",))]
    for i in range(s["depth"]):
        b = f"model.blocks.{i}."
        spec += [(b + "norm1.weight", (E,), ("ones",)), (b + "norm1.bias", (E,), ("zeros",)),
                 (b + "filter.w1", (nb, bs, bs, 2), ("normal", 0.02)),
                 (b + "filter.b1", (1, E, 1, 1), ("normal", 0.02)),
                 (b + "filter.w2", (nb, bs, bs, 2), ("normal", 0.02)),
                 (b + "norm2.weight", (E,), ("ones",)), (b + "norm2.bias", (E,), ("zeros",)),
                 (b + "mlp.fc1.weight", (H, E), ("normal", math.sqrt(2.0 / E))),
                 (b + "mlp.fc1.bias", (H,), ("zeros",)),
                 (b + "mlp.fc2.weight", (E, H), ("normal", math.sqrt(1.0 / H))),
                 (b + "mlp.fc2.bias", (E,), ("zeros",))]
    return spec


def _softshrink(x, lam):
    return torch.sign(x) * torch.clamp_min(x.abs() - lam, 0.0)


class AFNO:
    """The reference model at `params`' shapes, in `precision`."""

    def __init__(self, params, device, precision="float32"):
        check_supported(params)
        self.s = shapes(params)
        self.q = quantizer(precision)
        self.lam = float(params["sparsity_threshold"])

    def _filter(self, W, b, x):
        q, nb = self.q, self.s["nb"]
        B, E, h, w = x.shape
        xf = torch.fft.rfft2(q(x), norm="ortho").reshape(B, nb, E // nb, h, w // 2 + 1)
        w1 = W[b + "filter.w1"]
        w2 = W[b + "filter.w2"]
        o = torch.einsum("bkihw,kio->bkohw", q(xf), q(torch.complex(w1[..., 0], w1[..., 1])))
        o = torch.complex(torch.relu(o.real), torch.relu(o.imag))
        o = torch.einsum("bkohw,koi->bkihw", q(o), q(torch.complex(w2[..., 0], w2[..., 1])))
        o = torch.complex(_softshrink(o.real, self.lam), _softshrink(o.imag, self.lam))
        y = torch.fft.irfft2(q(o.reshape(B, E, h, w // 2 + 1)), s=(h, w), norm="ortho")
        return y + W[b + "filter.b1"] + x

    def forward(self, W, x):
        """One forecast step: (B, C, H, W) -> (B, C, H, W)."""
        q, s = self.q, self.s
        B, C = x.shape[:2]
        (ph, pw), (gh, gw) = s["patch"], s["grid"]
        patches = x.reshape(B, C, gh, ph, gw, pw).permute(0, 2, 4, 1, 3, 5)
        patches = patches.reshape(B, gh * gw, C * ph * pw).transpose(1, 2)
        wpe = W["model.patch_embed.weight"].reshape(s["E"], -1)
        h = torch.matmul(q(wpe), q(patches)) + W["model.patch_embed.bias"][:, None]
        h = (h + W["model.pos_embed"]).reshape(B, s["E"], gh, gw)
        for i in range(s["depth"]):
            b = f"model.blocks.{i}."
            residual = h
            t = self._filter(W, b, instance_norm(h, W[b + "norm1.weight"], W[b + "norm1.bias"]))
            t = t + residual
            t = instance_norm(t, W[b + "norm2.weight"], W[b + "norm2.bias"])
            t = t.reshape(B, s["E"], gh * gw)
            t = gelu(torch.matmul(q(W[b + "mlp.fc1.weight"]), q(t)) + W[b + "mlp.fc1.bias"][:, None])
            t = torch.matmul(q(W[b + "mlp.fc2.weight"]), q(t)) + W[b + "mlp.fc2.bias"][:, None]
            h = t.reshape(B, s["E"], gh, gw) + residual
        y = torch.matmul(q(W["model.head_weight"]), q(h.reshape(B, s["E"], gh * gw)))
        y = y.reshape(B, ph, pw, C, gh, gw).permute(0, 3, 4, 1, 5, 2)
        return y.reshape(B, C, gh * ph, gw * pw)


# the reference model of this family, as the harness names it
Model = AFNO


def kernel_work(params, batch, train):
    """{kernel: [(launches, bytes, operations) of each launch shape]} one
    forecast step asks of the program's kernels under bf16 AMP: the MLP's
    GELU on bf16, each element read and written once."""
    if train:
        raise NotImplementedError("the AFNO cells serve forecasts")
    s = shapes(params)
    elems = batch * s["H"] * s["grid"][0] * s["grid"][1]
    return {"gelu": [(s["depth"], 4.0 * elems, 0.0)]}


def model_flops(params, batch, train):
    """The model's matrix products a forecast step: the patch embedding, the
    filters' blockwise complex MLPs (8 real operations a complex
    multiply-add, on every kept mode), the MLPs and the head. The FFTs are
    not products and are not counted."""
    if train:
        raise NotImplementedError("the AFNO cells serve forecasts")
    s = shapes(params)
    C, E, H, nb = s["C"], s["E"], s["H"], s["nb"]
    ph, pw = s["patch"]
    gh, gw = s["grid"]
    n, modes, bs = gh * gw, gh * (gw // 2 + 1), E // nb
    f = 2 * n * C * ph * pw * E * 2                       # patch embedding and head
    f += s["depth"] * (2 * 8 * modes * nb * bs * bs + 2 * n * 2 * E * H)
    return float(f * batch)
