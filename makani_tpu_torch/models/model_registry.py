"""Model registry: name -> network class, wrapped in a stepper.

Counterpart of makani_tpu/models/model_registry.py for the SFNO. The other
families (FNO, AFNO, ViT, DebugNet) and file-based registration are not
ported yet (ROADMAP, Queue 1).

`update_channel_params` ports the channel math of makani_tpu's
Trainer._update_parameters (utils/trainer.py:291-335) for a caller with no
dataset: the channel lists come from the config or from `n_channels`.
"""

import inspect

import torch

from makani_tpu_torch.models.networks.sfnonet import SphericalFourierNeuralOperatorNet
from makani_tpu_torch.models.preprocessor import Preprocessor2D
from makani_tpu_torch.models.stepper import MultiStepWrapper, SingleStepWrapper
from makani_tpu_torch.utils.device import resolve_device
from makani_tpu_torch.utils.yparams import ParamsBase

_model_registry = {"SFNO": SphericalFourierNeuralOperatorNet}


def list_models():
    return list(_model_registry)


def as_params(params):
    """A plain dict becomes a ParamsBase; a ParamsBase passes through."""
    return ParamsBase.from_dict(params) if isinstance(params, dict) else params


def update_channel_params(params, n_channels=None):
    """Fill N_in_channels, N_out_channels, the crop and local shapes and the
    derived defaults in place, as the Trainer does from its dataset. Without
    `in_channels` / `out_channels` in the config, both are range(n_channels).
    """
    params = as_params(params)
    if params.get("in_channels", None) is None or params.get("out_channels", None) is None:
        if n_channels is None:
            raise ValueError("the config names no in_channels/out_channels; pass n_channels")
        params["in_channels"] = list(range(n_channels))
        params["out_channels"] = list(range(n_channels))
    params["N_in_channels"] = len(params.in_channels)
    params["N_out_channels"] = len(params.out_channels)

    for axis in ("x", "y"):
        full = params[f"img_shape_{axis}"]
        crop = params.get(f"img_crop_shape_{axis}", None) or full
        offset = params.get(f"img_crop_offset_{axis}", None) or 0
        params[f"img_crop_shape_{axis}"] = crop
        params[f"img_crop_offset_{axis}"] = offset
        params[f"img_local_shape_{axis}"] = crop
        params[f"img_local_offset_{axis}"] = 0

    params["N_in_predicted_channels"] = params.N_in_channels
    if params.get("add_zenith", None) is None:
        params["add_zenith"] = False
    if params.add_zenith:
        params["N_in_channels"] = params.N_in_channels + 1
    if params.n_history >= 1:
        params["N_in_channels"] = (params.n_history + 1) * params.N_in_channels
        params["N_in_predicted_channels"] = params.N_in_predicted_channels * (params.n_history + 1)
    if params.get("add_grid", False):
        n_grid_chan = 2
        if params.get("gridtype") == "sinusoidal" and params.get("grid_num_frequencies"):
            n_grid_chan *= params.grid_num_frequencies
        params["N_in_channels"] = params.N_in_channels + n_grid_chan
    if params.get("add_orography", False):
        params["N_in_channels"] = params.N_in_channels + 1
    if params.get("add_landmask", False):
        params["N_in_channels"] = params.N_in_channels + 2
    if params.get("n_future", None) is None:
        params["n_future"] = 0  # single-step serving, as the inference CLI sets it
    params["N_target_channels"] = (params.n_future + 1) * params.N_out_channels
    if params.get("history_normalization_mode", None) is None:
        params["history_normalization_mode"] = "none"
    return params


def _filter_kwargs(cls, kwargs):
    valid = set(inspect.signature(cls.__init__).parameters) - {"self", "device", "generator"}
    return {k: tuple(v) if isinstance(v, list) else v
            for k, v in kwargs.items() if k in valid}


def get_model(params, device=None, generator=None):
    """Build the configured network on `device` (default "cuda"; raises when
    CUDA is absent unless device="cpu") and wrap it in a stepper. Weights are
    drawn from `generator`, by default one on `device` seeded with the
    config's global_seed (333)."""
    params = as_params(params)
    device = resolve_device(device)
    if params.nettype not in _model_registry:
        raise NotImplementedError(f"model {params.nettype!r} is not ported yet; "
                                  f"ported: {list_models()}")
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(int(params.get("global_seed", 333)))

    inp_shape = (params.img_crop_shape_x, params.img_crop_shape_y)
    out_shape = ((params.out_shape_x, params.out_shape_y)
                 if params.get("out_shape_x", None) and params.get("out_shape_y", None)
                 else inp_shape)
    cls = _model_registry[params.nettype]
    all_kwargs = dict(params.to_dict())
    all_kwargs.update(inp_shape=tuple(inp_shape), out_shape=tuple(out_shape),
                      inp_chans=params.N_in_channels, out_chans=params.N_out_channels)
    net = cls(**_filter_kwargs(cls, all_kwargs), device=device, generator=generator)

    preprocessor = Preprocessor2D(params, device=device)
    lsm_mask_channels = tuple(params.get("lsm_mask_channels", ()) or ())
    if params.n_future > 0:
        return MultiStepWrapper(preprocessor, net, n_future=params.n_future,
                                lsm_mask_channels=lsm_mask_channels)
    return SingleStepWrapper(preprocessor, net, lsm_mask_channels=lsm_mask_channels)
