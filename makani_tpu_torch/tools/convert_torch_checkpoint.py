"""Convert a reference (PyTorch Makani) checkpoint into the port's format.

    python3 -m makani_tpu_torch.tools.convert_torch_checkpoint --input ckpt_mp0.tar \\
        --output DIR --yaml_config config/sfnonet.yaml --config NAME

Counterpart of makani_tpu/tools/convert_torch_checkpoint.py: the reference's
`ckpt_mp0.tar` (legacy, one model-parallel rank) or flexible checkpoint of
an SFNO is mapped onto makani_tpu's parameter names (this module's copy of
`map_reference_state_dict`: complex weights become real pairs, 1x1 conv
kernels are squeezed), loaded into the port's model by
tools/convert_jax_params.load_jax_params, and written with
utils/checkpoint.save_checkpoint, its iters and epoch as the counters. The
archive is read with ``torch.load(..., weights_only=True)``. Unlike
makani_tpu's, which keeps the initial value of a parameter the archive
lacks, the conversion raises unless the map covers every parameter of the
model and uses every mapped tensor.

Name map (reference -> makani_tpu), SingleStepWrapper/SFNO:
  model.encoder.fwd.{2i}.*          -> model/encoder/fwd_{i}/*
  model.encoder.fwd.{2L}.*          -> model/encoder/out/*
  model.blocks.{i}.filter.filter.*  -> model/blocks_{i}/SpectralFilterLayer_0/filter/*
  model.blocks.{i}.norm{0,1}.*      -> model/blocks_{i}/norm{0,1}/*
  model.blocks.{i}.{inner,outer}_skip.weight -> model/blocks_{i}/..._skip/weight
  model.blocks.{i}.mlp.fwd.0.*      -> model/blocks_{i}/mlp/fc1/*
  model.blocks.{i}.mlp.fwd.3.*      -> model/blocks_{i}/mlp/fc2/*
  model.decoder.*                   -> model/decoder/*
  model.pos_embed                   -> model/pos_embed
  model.residual_transform.weight   -> model/residual_transform
"""

import argparse
import re

import numpy as np
import torch

from makani_tpu_torch.tools.convert_jax_params import load_jax_params


def _to_pair(arr):
    """complex array -> real-pair array (..., 2)."""
    if np.iscomplexobj(arr):
        return np.stack([arr.real, arr.imag], axis=-1).astype(np.float32)
    return np.asarray(arr, dtype=np.float32)


def _squeeze_conv(arr):
    """1x1 conv kernel (O, I, 1, 1) -> (O, I)."""
    a = np.asarray(arr)
    if a.ndim == 4 and a.shape[-1] == 1 and a.shape[-2] == 1:
        return a[..., 0, 0]
    return a


def map_reference_state_dict(state_dict, encoder_layers=1):
    """Reference state_dict (name -> numpy array) -> flat dict of
    makani_tpu's parameter paths ("/"-joined keys)."""
    out = {}
    final_idx = 2 * encoder_layers

    def enc_name(stack, idx, leaf):
        if int(idx) == final_idx:
            return f"model/{stack}/out/{leaf}"
        return f"model/{stack}/fwd_{int(idx) // 2}/{leaf}"

    for key, val in state_dict.items():
        key = re.sub(r"^module\.", "", key)
        val = np.asarray(val)
        m = re.match(r"model\.(encoder|decoder)\.fwd\.(\d+)\.(weight|bias)$", key)
        if m:
            out[enc_name(m.group(1), m.group(2), m.group(3))] = _squeeze_conv(val)
            continue
        m = re.match(r"model\.blocks\.(\d+)\.filter\.filter\.(weight|bias)$", key)
        if m:
            leaf = "weight" if m.group(2) == "weight" else "bias_const"
            out[f"model/blocks_{m.group(1)}/SpectralFilterLayer_0/filter/{leaf}"] = _to_pair(val)
            continue
        # SpectralAttention (filter_type="non-linear"): w ParameterList,
        # wout, optional b ParameterList
        m = re.match(r"model\.blocks\.(\d+)\.filter\.filter\.(w|b)\.(\d+)$", key)
        if m:
            out[f"model/blocks_{m.group(1)}/SpectralFilterLayer_0/filter/"
                f"{m.group(2)}_{m.group(3)}"] = _to_pair(val)
            continue
        m = re.match(r"model\.blocks\.(\d+)\.filter\.filter\.wout$", key)
        if m:
            out[f"model/blocks_{m.group(1)}/SpectralFilterLayer_0/filter/wout"] = _to_pair(val)
            continue
        m = re.match(r"model\.blocks\.(\d+)\.(norm0|norm1)\.(weight|bias)$", key)
        if m:
            out[f"model/blocks_{m.group(1)}/{m.group(2)}/{m.group(3)}"] = np.asarray(val, np.float32)
            continue
        m = re.match(r"model\.blocks\.(\d+)\.(inner_skip|outer_skip)\.weight$", key)
        if m:
            out[f"model/blocks_{m.group(1)}/{m.group(2)}/weight"] = _squeeze_conv(val)
            continue
        m = re.match(r"model\.blocks\.(\d+)\.mlp\.fwd\.(\d+)\.(weight|bias)$", key)
        if m:
            fc = "fc1" if int(m.group(2)) == 0 else "fc2"
            out[f"model/blocks_{m.group(1)}/mlp/{fc}/{m.group(3)}"] = _squeeze_conv(val)
            continue
        if key == "model.pos_embed":
            out["model/pos_embed"] = np.asarray(val, np.float32)
            continue
        # frequency pos-embed: a ParameterList [rcoeffs, ccoeffs]
        if key == "model.pos_embed.0":
            out["model/pos_embed_r"] = np.asarray(val, np.float32)
            continue
        if key == "model.pos_embed.1":
            out["model/pos_embed_c"] = np.asarray(val, np.float32)
            continue
        if key == "model.residual_transform.weight":
            out["model/residual_transform"] = _squeeze_conv(val)
            continue
        # preprocessor buffers and unknown keys are skipped (non-learnable)
    return out


def convert(torch_ckpt_path, output_path, params):
    """The reference archive at `torch_ckpt_path` -> a port checkpoint at
    `output_path` (model only). Returns the converted state dict."""
    from makani_tpu_torch.models.model_registry import get_model
    from makani_tpu_torch.utils.checkpoint import save_checkpoint

    ckpt = torch.load(torch_ckpt_path, map_location="cpu", weights_only=True)
    state = ckpt.get("model_state", ckpt)
    state_np = {k: v.numpy() for k, v in state.items()}
    model = get_model(params, device="cpu")
    load_jax_params(model, map_reference_state_dict(state_np, params.get("encoder_layers", 1)))
    weights = model.state_dict()
    save_checkpoint(output_path, weights, None,
                    {"iters": int(ckpt.get("iters", 0)), "epoch": int(ckpt.get("epoch", 0))})
    return weights


def main(argv=None):
    from makani_tpu_torch.models.model_registry import update_channel_params
    from makani_tpu_torch.utils.dataset_metadata import parse_dataset_metadata
    from makani_tpu_torch.utils.yparams import YParams

    parser = argparse.ArgumentParser()
    parser.add_argument("--input", required=True, help="reference ckpt_mp0.tar")
    parser.add_argument("--output", required=True, help="output checkpoint dir")
    parser.add_argument("--yaml_config", required=True)
    parser.add_argument("--config", required=True)
    args = parser.parse_args(argv)

    params = YParams(args.yaml_config, args.config)
    if params.get("metadata_json_path"):
        parse_dataset_metadata(params.metadata_json_path, params)
    weights = convert(args.input, args.output, update_channel_params(params))
    print(f"converted {len(weights)} parameters into {args.output}")
    return 0


if __name__ == "__main__":
    main()
