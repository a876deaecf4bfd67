"""Carry makani_tpu (flax) weights and Adam state into the port.

`load_jax_params(model, flat)` takes the flax parameter tree flattened with
``flax.traverse_util.flatten_dict(params, sep="/")`` as numpy arrays, e.g.

  model/encoder/fwd_0/weight (O, I)      -> model.encoder.fwd_0.weight
  model/blocks_3/SpectralFilterLayer_0/filter/weight (C, O, L, 2)
                                         -> model.blocks.3.filter_layer.filter.weight
                                            (2, L, C, O), the dhconv kernel layout
                                            (other filter operators: unchanged)
  model/blocks_3/norm0/weight            -> model.blocks.3.norm0.weight
  model/blocks_3/SpectralFilterLayer_0/filter/w_0 ([L,] I, H, 2)
                                         -> model.blocks.3.filter_layer.filter.w_0
                                            (the non-linear filter's complex
                                            weights, biases b_<l> and wout as
                                            real pairs, act_<l>/bias: unchanged)
  model/residual_transform (O, I)        -> model.residual_transform
  model/scan_blocks/block/SpectralFilterLayer_0/filter/weight (n, C, O, L, 2)
                                         -> model.scan_blocks.block.filter_layer.filter.weight
                                            (n, 2, L, C, O): scan_layers' stacked
                                            leaves keep their leading layer axis
  model/blocks_3/SpectralFilterLayer_0/filter/weight/factor_0 (C, R, 2)
                                         -> model.blocks.3.filter_layer.filter.weight.factor_0
                                            (a factorized filter's factors, unchanged)

and copies them into `model` (a stepper from get_model). Every parameter of
the model must be covered and every given array used; otherwise it raises.

`load_jax_opt_state(opt_state, model, flat_state)` does the same for the
Adam state of utils/optimizers: `flat_state` holds makani_tpu's ``count`` and
its ``mu`` and ``nu`` trees flattened like the parameters (bf16 moments given
as float32 numpy).
"""

import numpy as np
import torch

from makani_tpu_torch.utils.param_layout import jax_key_to_torch, to_port_layout


def _map_flat(state, flat, what):
    """{port name: float32 numpy in the port's layout} for a flattened
    makani_tpu tree; raises on a missing or unused key or a wrong shape."""
    mapped, unused = {}, []
    for key, value in flat.items():
        tkey = jax_key_to_torch(key)
        if tkey not in state:
            unused.append(key)
            continue
        arr = to_port_layout(tkey, np.asarray(value, dtype=np.float32), state[tkey].shape)
        if arr.shape != tuple(state[tkey].shape):
            raise ValueError(f"{key}: shape {arr.shape} does not fit {tkey} "
                             f"{tuple(state[tkey].shape)}")
        mapped[tkey] = arr
    missing = sorted(set(state) - set(mapped))
    if missing or unused:
        raise KeyError(f"{what} not covered: {missing}; arrays not used: {sorted(unused)}")
    return mapped


def load_jax_params(model, flat):
    mapped = _map_flat(model.state_dict(), flat, "parameters")
    model.load_state_dict({k: torch.tensor(v) for k, v in mapped.items()})
    return model


def load_jax_opt_state(opt_state, model, flat_state):
    """Copy makani_tpu's Adam state into `opt_state` (an AdamState of
    utils/optimizers keyed like model.named_parameters()), in place; the
    moments keep the dtype of `opt_state`."""
    params = dict(model.named_parameters())
    for name in ("mu", "nu"):
        moments = getattr(opt_state, name)
        if set(moments) != set(params):
            raise KeyError(f"opt_state.{name} is not keyed like the model's parameters")
        for key, arr in _map_flat(moments, flat_state[name], f"opt_state.{name}").items():
            moments[key].copy_(torch.from_numpy(np.ascontiguousarray(arr)))
    opt_state.count = int(flat_state["count"])
    return opt_state
