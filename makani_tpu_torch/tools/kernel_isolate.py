"""The probe battery on the card: the counterpart of scripts/pallas_isolate.py.

    python3 -m makani_tpu_torch.tools.kernel_isolate [case ...] [--device cpu]

Nine cases, the script's names and shapes (C = O = 16, M = 128, B = 2, L = 4,
float32): the seven probe kernels of csrc/probes.cu, each isolating one
construct of the dhconv kernel, and the complex dhconv kernel
(csrc/dhconv_complex.cu, through complex_kernels.contract_dhconv_kernel)
forward and through its autograd backward. The script fed constants (ones,
1.234567); here each case's inputs are normal values from a numpy seed, so a
transposed operand cannot hide. Each case runs its kernel, checks it against
the plain twin on the same inputs (TWIN_TOL of the largest magnitude) and
prints PASS or FAIL as the script does; a case that raises is reported as
FAIL and the battery goes on. `main` returns 1 if any case failed.

Each probe has a wrapper that launches its kernel on CUDA tensors (counted in
kernels.launches["probe_<name>"]) and runs its twin, `<name>_plain`, on CPU
tensors (device="cpu", as the tests run it).
"""

import argparse
import sys

import numpy as np
import torch

from makani_tpu_torch.ops import complex_kernels
from makani_tpu_torch.ops.kernels import dispatch, launcher, launches, raise_on
from makani_tpu_torch.ops.spectral_mm import split_bf16
from makani_tpu_torch.utils.device import resolve_device

C, O, M = 16, 16, 128
B, L = 2, 4
# kernel vs twin: the same float32 products (bf16 parts for bf16_split)
# summed in another order, a few ulps of the largest partial sum
TWIN_TOL = 1e-5


def _launch(name, inputs, outputs, *dims):
    """Launches probe `name` on contiguous float32 CUDA tensors."""
    dev = inputs[0].device
    for t in (*inputs, *outputs):
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous float32 tensors on one device")
    launch = launcher(name)
    with torch.cuda.device(dev):
        rc = launch(*(t.data_ptr() for t in (*inputs, *outputs)), *dims,
                    torch.cuda.current_stream().cuda_stream)
    raise_on(rc, name)
    launches[name] += 1


def _dot_shapes(a, b, transposed):
    if a.ndim != 2 or b.ndim != 2 or a.shape[0 if transposed else 1] != b.shape[0]:
        raise ValueError(f"{tuple(a.shape)} does not contract with {tuple(b.shape)}")
    o = a.shape[1] if transposed else a.shape[0]
    return o, b.shape[0], b.shape[1]


def _block_shapes(x, w):
    if x.ndim != 4 or w.ndim != 3 or (x.shape[1], x.shape[2]) != (w.shape[0], w.shape[1]):
        raise ValueError(f"expected x (B, L, C, M) and w (L, C, O), got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    return x.shape[0], x.shape[1], x.shape[2], w.shape[2], x.shape[3]


# ---- the plain twins ----

def copy_plain(x):
    return x * 2.0


def dot_plain_plain(a, b):
    """a (O, C) . b (C, M)."""
    _dot_shapes(a, b, False)
    return torch.matmul(a, b)


def dot_transposed_plain(a, b):
    """a (C, O), b (C, M), contracting dim 0 of both."""
    _dot_shapes(a, b, True)
    return torch.matmul(a.T, b)


def grid_blocks_plain(x, w):
    """out[b, l] = w[l]^T x[b, l]: x (B, L, C, M), w (L, C, O) -> (B, L, O, M)."""
    _block_shapes(x, w)
    return torch.matmul(w.transpose(-1, -2), x)


def stacked_output_plain(x, w):
    r = grid_blocks_plain(x, w)
    return torch.stack([r, -r])


def multi_output_plain(x, w):
    r = grid_blocks_plain(x, w)
    return r, -r


def bf16_split_plain(a, b):
    """a (C, O), b (C, M): (ah^T bh + ah^T bl) + al^T bh in float32."""
    _dot_shapes(a, b, True)
    ah, al = split_bf16(a.T)
    bh, bl = split_bf16(b)
    return (torch.matmul(ah, bh) + torch.matmul(ah, bl)) + torch.matmul(al, bh)


# ---- the kernels' wrappers ----

def probe_copy(x):
    if not dispatch(x):
        return copy_plain(x)
    out = torch.empty_like(x)
    _launch("probe_copy", (x,), (out,), x.numel())
    return out


def _dot(name, a, b, transposed):
    o, c, m = _dot_shapes(a, b, transposed)
    out = torch.empty((o, m), device=a.device, dtype=torch.float32)
    _launch(name, (a, b), (out,), o, c, m)
    return out


def probe_dot_plain(a, b):
    if not dispatch(a):
        return dot_plain_plain(a, b)
    return _dot("probe_dot_plain", a, b, False)


def probe_dot_transposed(a, b):
    if not dispatch(a):
        return dot_transposed_plain(a, b)
    return _dot("probe_dot_transposed", a, b, True)


def probe_bf16_split(a, b):
    if not dispatch(a):
        return bf16_split_plain(a, b)
    return _dot("probe_bf16_split", a, b, True)


def probe_grid_blocks(x, w):
    if not dispatch(x):
        return grid_blocks_plain(x, w)
    b, l, c, o, m = _block_shapes(x, w)
    out = torch.empty((b, l, o, m), device=x.device, dtype=torch.float32)
    _launch("probe_grid_blocks", (x, w), (out,), b, l, c, o, m)
    return out


def probe_stacked_output(x, w):
    if not dispatch(x):
        return stacked_output_plain(x, w)
    b, l, c, o, m = _block_shapes(x, w)
    out = torch.empty((2, b, l, o, m), device=x.device, dtype=torch.float32)
    _launch("probe_stacked_output", (x, w), (out,), b, l, c, o, m)
    return out


def probe_multi_output(x, w):
    if not dispatch(x):
        return multi_output_plain(x, w)
    b, l, c, o, m = _block_shapes(x, w)
    out1, out2 = (torch.empty((b, l, o, m), device=x.device, dtype=torch.float32)
                  for _ in range(2))
    _launch("probe_multi_output", (x, w), (out1, out2), b, l, c, o, m)
    return out1, out2


# ---- the complex dhconv kernel, on the script's stacked real planes ----

def _complex(planes):
    return torch.complex(planes[0], planes[1])


def dhconv_tiny(xp, wp):
    """xp (2, B, C, L, M), wp (2, C, O, L) real planes -> (re, im) of the
    complex dhconv contraction, through the kernel's differentiable wrapper."""
    o = complex_kernels.contract_dhconv_kernel(_complex(xp), _complex(wp), 3)
    return o.real, o.imag


def dhconv_tiny_plain(xp, wp):
    o = complex_kernels.contract_dhconv_plain(_complex(xp), _complex(wp), 3)
    return o.real, o.imag


def dhconv_grad(xp, wp):
    """Gradients with respect to the real planes of sum |o|^2, through the
    kernel's autograd backward (dx by the kernel, dw an einsum)."""
    xp, wp = xp.detach().requires_grad_(), wp.detach().requires_grad_()
    with torch.enable_grad():
        o = complex_kernels.contract_dhconv_kernel(_complex(xp), _complex(wp), 3)
        loss = (o.real.square() + o.imag.square()).sum()
        return torch.autograd.grad(loss, (xp, wp))


def dhconv_grad_plain(xp, wp):
    """The same gradients by hand: g = 2 o, dx = sum_o conj(w) g (the twin on
    conj(w) transposed), dw = sum_{b,m} conj(x) g."""
    x, w = _complex(xp), _complex(wp)
    g = 2 * complex_kernels.contract_dhconv_plain(x, w, 3)
    dx = complex_kernels.contract_dhconv_plain(g, w.conj().transpose(0, 1), 3)
    dw = torch.einsum("bilm,bolm->iol", x.conj(), g)
    return torch.stack([dx.real, dx.imag]), torch.stack([dw.real, dw.imag])


# name, the inputs' shapes, kernel, twin: the script's CASES in its order
CASES = [
    ("copy", [(8, 128)], probe_copy, copy_plain),
    ("dot_plain", [(O, C), (C, M)], probe_dot_plain, dot_plain_plain),
    ("dot_transposed", [(C, O), (C, M)], probe_dot_transposed, dot_transposed_plain),
    ("grid_blocks", [(B, L, C, M), (L, C, O)], probe_grid_blocks, grid_blocks_plain),
    ("stacked_output_5d", [(B, L, C, M), (L, C, O)], probe_stacked_output,
     stacked_output_plain),
    ("multi_output", [(B, L, C, M), (L, C, O)], probe_multi_output, multi_output_plain),
    ("bf16_split", [(C, O), (C, M)], probe_bf16_split, bf16_split_plain),
    ("dhconv_tiny", [(2, B, C, L, M), (2, C, O, L)], dhconv_tiny, dhconv_tiny_plain),
    ("dhconv_grad", [(2, B, C, L, M), (2, C, O, L)], dhconv_grad, dhconv_grad_plain),
]


def case_inputs(shapes, seed, dev):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(*s).astype(np.float32)).to(dev) for s in shapes]


def run_case(name, shapes, kernel, twin, dev, seed=0):
    """Runs one case, prints PASS or FAIL; True when it passed."""
    try:
        inputs = case_inputs(shapes, seed, dev)
        got, want = kernel(*inputs), twin(*inputs)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        err = 0.0
        for g, w in zip(got, want, strict=True):
            if g.shape != w.shape:
                raise AssertionError(f"shape {tuple(g.shape)}, twin {tuple(w.shape)}")
            err = max(err, float((g.double() - w.double()).abs().max() / w.abs().max()))
        if not err < TWIN_TOL:
            raise AssertionError(f"rel err vs twin {err:.3g} >= {TWIN_TOL:g}")
        print(f"PASS {name}: " + ", ".join(str(tuple(g.shape)) for g in got)
              + f"; rel err vs twin {err:.3g}", flush=True)
        return True
    except Exception as e:  # the report goes on; main's return code carries the failure
        msg = (str(e).splitlines() or [""])[0][:200]
        print(f"FAIL {name}: {type(e).__name__}: {msg}", flush=True)
        return False


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cases", nargs="*", help="case names (default: all nine)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    names = [c[0] for c in CASES]
    unknown = sorted(set(args.cases) - set(names))
    if unknown:
        ap.error(f"unknown cases {unknown}; the cases are {names}")
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        print(f"device: {torch.cuda.get_device_name(dev)}; TF32 off", flush=True)
    else:
        print(f"device: {dev}", flush=True)
    results = [run_case(*case, dev) for case in CASES if not args.cases or case[0] in args.cases]
    return 0 if all(results) else 1


if __name__ == "__main__":
    sys.exit(main())
