"""Model registry: name -> network class, wrapped in a stepper.

Counterpart of makani_tpu/models/model_registry.py: the SFNO, the planar
FNO, AFNO v2 ("AFNO"), AFNO v1 ("AFNOv1"), the ViT and the DebugNet of the
pipeline self-test, in makani_tpu's order. `register_model` takes a
torch.nn.Module subclass or a "path/to/file.py:ClassName" string, and
`get_model` registers a `nettype` it does not know from its file, as
makani_tpu's does. A registered class is built with the config's keys that
name parameters of its __init__, plus `device` and `generator`.

Every network runs on every layout of parallel/comm (data, h, w, fin,
fout). The registry's families take a rank's (h, w) patch and split their
own work (`spatially_parallel`); a class that does not say so, as one
registered from a file, runs on the whole field on every rank
(spmd.whole_field: the patches gathered, the class run with the model axes
serial, the output cut back to the rank's patch) with every leaf whole, as
XLA's partitioner lets makani_tpu run any network on its mesh.

`update_channel_params` ports the channel math of makani_tpu's
Trainer._update_parameters (utils/trainer.py:291-335): the channel counts and
the image, crop and local shapes come from a dataset where one is given (the
Trainer's and the Inferencer's evaluation dataset), else from the config, with
the channel lists from the config or from `n_channels`.
"""

import importlib.util
import inspect
import os

import torch

from makani_tpu_torch.models.networks.afnonet import AdaptiveFourierNeuralOperatorNetV1
from makani_tpu_torch.models.networks.afnonet_v2 import AdaptiveFourierNeuralOperatorNet
from makani_tpu_torch.models.networks.debug import DebugNet
from makani_tpu_torch.models.networks.sfnonet import (
    FourierNeuralOperatorNet,
    SphericalFourierNeuralOperatorNet,
)
from makani_tpu_torch.models.networks.vit import VisionTransformer
from makani_tpu_torch.models.preprocessor import Preprocessor2D
from makani_tpu_torch.models.stepper import MultiStepWrapper, SingleStepWrapper
from makani_tpu_torch.parallel import partitioning
from makani_tpu_torch.utils.device import resolve_device
from makani_tpu_torch.utils.features import get_auxiliary_channels
from makani_tpu_torch.utils.yparams import ParamsBase

_model_registry = {
    "SFNO": SphericalFourierNeuralOperatorNet,
    "FNO": FourierNeuralOperatorNet,
    "AFNO": AdaptiveFourierNeuralOperatorNet,
    "AFNOv1": AdaptiveFourierNeuralOperatorNetV1,
    "ViT": VisionTransformer,
    "DebugNet": DebugNet,
}


def _register_from_module(model, name=None):
    if not (isinstance(model, type) and issubclass(model, torch.nn.Module)):
        raise ValueError("Only subclasses of torch.nn.Module can be registered. Provided model "
                         f"is of type {type(model)}")
    if name is None:
        name = model.__name__
    if name in _model_registry:
        raise ValueError(f"Name {name} already in use")
    _model_registry[name] = model


def _register_from_file(model_string, name=None):
    parts = model_string.split(":")
    if len(parts) != 2:
        raise ValueError(f"Expected string of format 'path/to/model_file.py:ModuleName' but got "
                         f"{model_string!r}")
    model_path, model_handle = parts
    if not os.path.exists(model_path):
        raise ValueError(f"Expected string of format 'path/to/model_file.py:ModuleName' but "
                         f"{model_path} does not exist.")
    spec = importlib.util.spec_from_file_location(model_handle, model_path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    _register_from_module(getattr(module, model_handle), name)


def register_model(model, name=None):
    """Register a torch.nn.Module subclass, or the class a
    "path/to/file.py:ClassName" string names, under `name` (default: the
    class's name)."""
    if isinstance(model, str):
        _register_from_file(model, name)
    else:
        _register_from_module(model, name)


def list_models():
    return list(_model_registry)


def as_params(params):
    """A plain dict becomes a ParamsBase; a ParamsBase passes through."""
    return ParamsBase.from_dict(params) if isinstance(params, dict) else params


_DATASET_SHAPES = tuple(f"img_{kind}_{axis}" for kind in ("shape", "crop_shape", "crop_offset",
                                                           "local_shape", "local_offset")
                        for axis in ("x", "y"))


def update_channel_params(params, n_channels=None, dataset=None):
    """Fill N_in_channels, N_out_channels, the crop and local shapes,
    aux_channel_names and the derived defaults in place. With a `dataset`,
    its channel selections and shapes count, as in makani_tpu's Trainer;
    without, the config's, and where it names no `in_channels` /
    `out_channels`, both are range(n_channels).
    """
    params = as_params(params)
    if dataset is not None:
        params["N_in_channels"] = len(dataset.in_channels)
        params["N_out_channels"] = len(dataset.out_channels)
        for key in _DATASET_SHAPES:
            params[key] = getattr(dataset, key)
    else:
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
    params["aux_channel_names"] = get_auxiliary_channels(**params.to_dict())
    if params.get("n_future", None) is None:
        params["n_future"] = 0  # single-step serving, as the inference CLI sets it
    params["N_target_channels"] = (params.n_future + 1) * params.N_out_channels
    if params.get("history_normalization_mode", None) is None:
        params["history_normalization_mode"] = "none"
    return params


def _init_parameters(cls):
    """The keyword parameters of cls.__init__, with those of the base classes
    it passes **kwargs on to."""
    names = set()
    for klass in cls.__mro__:
        params = inspect.signature(klass.__init__).parameters
        names |= {n for n, p in params.items() if p.kind != p.VAR_KEYWORD}
        if not any(p.kind == p.VAR_KEYWORD for p in params.values()):
            break
    return names


def _filter_kwargs(cls, kwargs):
    valid = _init_parameters(cls) - {"self", "device", "generator"}
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
        register_model(params.nettype, params.nettype)
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
        model = MultiStepWrapper(preprocessor, net, n_future=params.n_future,
                                 lsm_mask_channels=lsm_mask_channels, global_hw=inp_shape)
    else:
        model = SingleStepWrapper(preprocessor, net, lsm_mask_channels=lsm_mask_channels,
                                  global_hw=inp_shape)
    # on model-parallel ranks the leaves split over h, w, fin and fout keep
    # the rank's shard (a network that is not spatially parallel keeps them
    # whole)
    model.shards = partitioning.shard_module(model)
    return model
