"""How the port's parameters lie in makani_tpu's parameter tree.

The port names a parameter as its stepper's `named_parameters()` does
(``model.blocks.3.filter_layer.filter.weight``); makani_tpu names the same
leaf by its flax path (``model/blocks_3/SpectralFilterLayer_0/filter/weight``).
Every leaf has the same shape and element order in both, except the
non-separable dhconv filter weight: the port stores ``(2, L, C, O)`` (plane
0 = re), the layout the dhconv kernels read, and makani_tpu ``(C, O, L, 2)``.
The other filter variants keep makani_tpu's ``(C, [O,] L[, M], 2)``, and the
non-linear filter's leaves (``w_<l>``, ``b_<l>``, ``wout``,
``act_<l>/bias``) keep theirs under their own names; of the filter weights,
only the separable diagonal one ``(C, L, M, 2)`` has four dimensions, and its first is never 2 (SpectralConv refuses in_channels 2
there), so a 4-D filter weight whose first dimension is 2 is the stacked one.
The scanned middle blocks' leaves (``scan_blocks.block.<name>``, makani_tpu's
``scan_blocks/block/<name>``) carry a leading layer axis in both packages;
the stacked dhconv weight is then (n, 2, L, C, O) against (n, C, O, L, 2).

`from_port_layout` is the inverse of `to_port_layout`: the weights and
gradients dump writes makani_tpu's layout. `jax_view` and `port_view` do the
same on torch tensors, as views (Adafactor keeps its statistics on
makani_tpu's layout of each leaf).

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


def layer_axes(key):
    """Leading layer axes of the port's leaf `key`: 1 for the scanned middle
    blocks' weights (``scan_blocks.block.<name>``), whose layer axis leads in
    both packages, else 0."""
    return 1 if "scan_blocks" in key.split(".") else 0


def is_stacked_filter(key, shape):
    """True for the port's stacked dhconv weight (2, L, C, O) (behind the
    layer axis under scan_blocks), given the port leaf's name and shape."""
    lead = layer_axes(key)
    return (key.endswith(FILTER_WEIGHT) and len(shape) == 4 + lead
            and int(shape[lead]) == 2)


def _axes(lead, inner):
    return tuple(range(lead)) + tuple(lead + a for a in inner)


def jax_dims(key, shape):
    """The port's dimension of each dimension of makani_tpu's layout of the
    leaf `key` of `shape` (jax_view's permutation: the stacked dhconv weight
    (2, L, C, O) is makani_tpu's (C, O, L, 2))."""
    if is_stacked_filter(key, shape):
        return list(_axes(layer_axes(key), (2, 3, 1, 0)))
    return list(range(len(shape)))


def jax_index_strides(key, shape):
    """Per dimension of the port's leaf, the stride of that dimension in the
    flat index of makani_tpu's layout of the same leaf."""
    shape = tuple(int(s) for s in shape)
    if is_stacked_filter(key, shape):
        # port (2, L, C, O) -> makani_tpu (C, O, L, 2): element (p, l, c, o)
        # lies at ((c*O + o)*L + l)*2 + p; a layer axis in front strides by
        # the whole weight
        lead = layer_axes(key)
        _, L, C, O = shape[lead:]
        strides, acc = [], 2 * L * C * O
        for s in reversed(shape[:lead]):
            strides.append(acc)
            acc *= s
        return tuple(reversed(strides)) + (1, 2, 2 * L * O, 2 * L)
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
    lead = layer_axes(key)
    if shape is None:
        stacked = key.endswith(FILTER_WEIGHT) and arr.ndim == 4 + lead
    else:
        stacked = is_stacked_filter(key, shape)
    return arr.transpose(_axes(lead, (3, 2, 0, 1))) if stacked else arr


def from_port_layout(key, arr):
    """A port leaf (numpy) in makani_tpu's layout: the stacked dhconv weight
    (2, L, C, O) goes back to (C, O, L, 2); every other leaf is unchanged."""
    if is_stacked_filter(key, arr.shape):
        return arr.transpose(_axes(layer_axes(key), (2, 3, 1, 0)))
    return arr


def jax_view(key, t):
    """A port leaf (torch) as a view in makani_tpu's layout."""
    if is_stacked_filter(key, t.shape):
        return t.permute(_axes(layer_axes(key), (2, 3, 1, 0)))
    return t


def port_view(key, t, port_shape):
    """The inverse of `jax_view`: a tensor in makani_tpu's layout of the
    port leaf `key` of shape `port_shape`, as a view in the port's layout."""
    if is_stacked_filter(key, port_shape):
        return t.permute(_axes(layer_axes(key), (3, 2, 0, 1)))
    return t
