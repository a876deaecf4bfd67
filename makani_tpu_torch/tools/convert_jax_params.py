"""Carry makani_tpu (flax) weights into the port's modules.

`load_jax_params(model, flat)` takes the flax parameter tree flattened with
``flax.traverse_util.flatten_dict(params, sep="/")`` as numpy arrays, e.g.

  model/encoder/fwd_0/weight (O, I)      -> model.encoder.fwd_0.weight
  model/blocks_3/SpectralFilterLayer_0/filter/weight (C, O, L, 2)
                                         -> model.blocks.3.filter_layer.filter.weight
                                            (2, L, C, O), the dhconv kernel layout
  model/blocks_3/norm0/weight            -> model.blocks.3.norm0.weight
  model/residual_transform (O, I)        -> model.residual_transform

and copies them into `model` (a stepper from get_model). Every parameter of
the model must be covered and every given array used; otherwise it raises.
"""

import re

import numpy as np
import torch

_FILTER_WEIGHT = "filter_layer.filter.weight"


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


def load_jax_params(model, flat):
    state = model.state_dict()
    mapped, unused = {}, []
    for key, value in flat.items():
        tkey = jax_key_to_torch(key)
        if tkey not in state:
            unused.append(key)
            continue
        arr = np.asarray(value, dtype=np.float32)
        if tkey.endswith(_FILTER_WEIGHT):
            arr = arr.transpose(3, 2, 0, 1)  # (C, O, L, 2) -> (2, L, C, O)
        if arr.shape != tuple(state[tkey].shape):
            raise ValueError(f"{key}: shape {arr.shape} does not fit {tkey} "
                             f"{tuple(state[tkey].shape)}")
        mapped[tkey] = torch.tensor(arr)
    missing = sorted(set(state) - set(mapped))
    if missing or unused:
        raise KeyError(f"parameters not covered: {missing}; arrays not used: {sorted(unused)}")
    model.load_state_dict(mapped)
    return model
