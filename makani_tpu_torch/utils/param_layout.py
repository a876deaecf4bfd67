"""How the port's parameters lie in makani_tpu's parameter tree.

The port names a parameter as its stepper's `named_parameters()` does
(``model.blocks.3.filter_layer.filter.weight``); makani_tpu names the same
leaf by its flax path (``model/blocks_3/SpectralFilterLayer_0/filter/weight``).
Every leaf has the same shape and element order in both, except the
non-separable dhconv filter weight: the port stores ``(2, L, C, O)`` (plane
0 = re), the layout the dhconv kernels read, and makani_tpu ``(C, O, L, 2)``.
The other filter variants keep makani_tpu's ``(C, [O,] L[, M], 2)``; of
those, only the separable diagonal weight ``(C, L, M, 2)`` has four
dimensions, and its first is never 2 (SpectralConv refuses in_channels 2
there), so a 4-D filter weight whose first dimension is 2 is the stacked one.

Three things follow from the map, and the optimizer needs the last two to
reproduce makani_tpu's stochastic rounding bit for bit: the key map itself,
the order of the leaves in ``jax.tree.flatten`` (dict keys sorted at every
level), and each element's flat index in makani_tpu's layout.
"""

import re

FILTER_WEIGHT = "filter_layer.filter.weight"


def jax_key_to_torch(key: str) -> str:
    parts = []
    for part in key.split("/"):
        m = re.fullmatch(r"blocks_(\d+)", part)
        if m:
            parts += ["blocks", m.group(1)]
        elif part == "SpectralFilterLayer_0":
            parts.append("filter_layer")
        else:
            parts.append(part)
    return ".".join(parts)


def torch_key_to_jax(key: str) -> str:
    parts = key.split(".")
    out = []
    i = 0
    while i < len(parts):
        part = parts[i]
        if part == "blocks" and i + 1 < len(parts) and parts[i + 1].isdigit():
            out.append(f"blocks_{parts[i + 1]}")
            i += 2
            continue
        out.append("SpectralFilterLayer_0" if part == "filter_layer" else part)
        i += 1
    return "/".join(out)


def jax_leaf_order(keys):
    """The port's parameter names in the order jax.tree.flatten visits the
    same leaves of makani_tpu's tree: sorted by path, component by component
    (so blocks_10 sorts before blocks_2, as the strings do)."""
    return sorted(keys, key=lambda k: tuple(torch_key_to_jax(k).split("/")))


def is_stacked_filter(key, shape):
    """True for the port's stacked dhconv weight (2, L, C, O), given the port
    leaf's name and shape."""
    return key.endswith(FILTER_WEIGHT) and len(shape) == 4 and int(shape[0]) == 2


def jax_index_strides(key, shape):
    """Per dimension of the port's leaf, the stride of that dimension in the
    flat index of makani_tpu's layout of the same leaf."""
    shape = tuple(int(s) for s in shape)
    if is_stacked_filter(key, shape):
        # port (2, L, C, O) -> makani_tpu (C, O, L, 2): element (p, l, c, o)
        # lies at ((c*O + o)*L + l)*2 + p
        _, L, _, O = shape
        return (1, 2, 2 * L * O, 2 * L)
    strides, acc = [], 1
    for s in reversed(shape):
        strides.append(acc)
        acc *= s
    return tuple(reversed(strides))


def to_port_layout(key, arr, shape=None):
    """A makani_tpu leaf (numpy) in the port's layout. `shape`, the port
    leaf's shape, tells a separable diagonal filter weight from the dhconv
    one (both 4-D in makani_tpu); without it a 4-D filter weight is taken for
    the dhconv weight."""
    if shape is None:
        stacked = key.endswith(FILTER_WEIGHT) and arr.ndim == 4
    else:
        stacked = is_stacked_filter(key, shape)
    return arr.transpose(3, 2, 0, 1) if stacked else arr
