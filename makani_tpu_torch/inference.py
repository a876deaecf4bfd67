"""Inference CLI (counterpart of makani_tpu/inference.py).

    python3 -m makani_tpu_torch.inference --yaml_config config/sfnonet.yaml \\
        --config NAME --mode score|epoch|lite [--device cuda|cpu] ...

Modes:
  score : one initial condition's rollout; the denormalized predictions and
          targets written as NetCDF (needs h5py)
  epoch : the whole evaluation dataset scored (ACC and RMSE curves, the RMSE
          over time and over space, as npy files in the experiment dir)
  lite  : a rollout without targets (SST persistence, IC perturbation),
          written as NetCDF (needs h5py)

The flags are makani_tpu's, plus --device (default cuda; without CUDA it
raises unless --device cpu). Several ranks over data, the spatial h and w
axes and the channel fin and fout axes are started by torchrun (`python -m
torch.distributed.run --standalone --nproc_per_node N -m
makani_tpu_torch.inference ... --h_parallel_size 2 --fin_parallel_size 2`;
parallel/comm): each rank scores its patch of its rows (with
--split_data_channels, its chunk of the metrics' channels), and rank 0 writes
the files. Every network runs on every layout, one registered from a file
without `spatially_parallel` on the whole field on each rank
(models/model_registry).
"""

import argparse
import logging
import os

import numpy as np

from makani_tpu_torch.parallel import comm
from makani_tpu_torch.utils import logging_utils
from makani_tpu_torch.utils.dataset_metadata import parse_dataset_metadata
from makani_tpu_torch.utils.nctools import write_prediction_file
from makani_tpu_torch.utils.yparams import YParams


def _parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--fin_parallel_size", default=1, type=int)
    parser.add_argument("--fout_parallel_size", default=1, type=int)
    parser.add_argument("--h_parallel_size", default=1, type=int)
    parser.add_argument("--w_parallel_size", default=1, type=int)
    parser.add_argument("--run_num", default="00", type=str)
    parser.add_argument("--yaml_config", default="./config/sfnonet.yaml", type=str)
    parser.add_argument("--config", default="base_73chq", type=str)
    parser.add_argument("--batch_size", default=-1, type=int)
    parser.add_argument("--amp_mode", default="none", type=str, choices=["none", "fp16", "bf16"])
    parser.add_argument("--checkpointing_level", default=0, type=int)
    parser.add_argument("--mode", default="score", type=str, choices=["score", "lite", "epoch"])
    parser.add_argument("--checkpoint_path", default=None, type=str)
    parser.add_argument("--save_checkpoint", default="flexible", type=str)
    parser.add_argument("--load_checkpoint", default="flexible", type=str)
    parser.add_argument("--inference_ic", default=0, type=int)
    parser.add_argument("--inference_output_path", default="./predictions.nc", type=str)
    parser.add_argument("--inference_target_path", default="./targets.nc", type=str)
    parser.add_argument("--overwrite_output_path", action="store_true")
    parser.add_argument("--enable_synthetic_data", action="store_true")
    parser.add_argument("--samples_offset", default=0, type=int,
                        help="inference IC offset into the dataset")
    parser.add_argument("--enable_odirect", action="store_true")
    parser.add_argument("--enable_benchy", action="store_true")
    parser.add_argument("--epsilon_factor", default=0, type=float)
    parser.add_argument("--split_data_channels", action="store_true")
    parser.add_argument("--device", default="cuda", type=str, choices=["cuda", "cpu"])
    return parser


def _denormalize(data, params, global_means, global_stds):
    oc = params["out_channels"]
    return np.asarray(data).squeeze(axis=1) * global_stds[:, oc] + global_means[:, oc]


def _write(path, data, overwrite):
    if overwrite and os.path.exists(path):
        os.remove(path)
    write_prediction_file(path, data)


def main(argv=None):
    args = _parser().parse_args(argv)
    sizes = [args.h_parallel_size, args.w_parallel_size, args.fin_parallel_size,
             args.fout_parallel_size]
    world_rank = comm.init(model_parallel_sizes=sizes,
                           model_parallel_names=["h", "w", "fin", "fout"],
                           device_type=args.device)

    params = YParams(os.path.abspath(args.yaml_config), args.config)
    params["model_parallel_sizes"] = sizes
    params["model_parallel_names"] = ["h", "w", "fin", "fout"]
    params["load_checkpoint"] = args.load_checkpoint
    params["save_checkpoint"] = args.save_checkpoint
    params["samples_offset"] = args.samples_offset
    params["enable_odirect"] = args.enable_odirect
    params["enable_benchy"] = args.enable_benchy
    params["epsilon_factor"] = args.epsilon_factor
    params["split_data_channels"] = args.split_data_channels
    params["world_size"] = comm.get_world_size()
    if args.batch_size > 0:
        params.batch_size = args.batch_size
    params["global_batch_size"] = params.batch_size
    params["batch_size"] = int(params["global_batch_size"] // comm.get_size("data"))

    exp_dir = os.path.join(params.exp_dir, args.config, str(args.run_num))
    os.makedirs(os.path.join(exp_dir, "deterministic_scores"), exist_ok=True)
    params["experiment_dir"] = os.path.abspath(exp_dir)
    params["checkpoint_path"] = (args.checkpoint_path if args.checkpoint_path is not None
                                 else os.path.join(exp_dir, "training_checkpoints", "best_ckpt"))
    params["resuming"] = False
    params["amp_mode"] = args.amp_mode
    params["checkpointing"] = args.checkpointing_level
    params["enable_synthetic_data"] = args.enable_synthetic_data
    params["n_future"] = 0

    logging_utils.config_logger()
    if world_rank == 0:
        logging_utils.log_to_file(logger_name=None,
                                  log_filename=os.path.join(exp_dir, "inference_out.log"))
        logging_utils.log_versions()
        params.log(logging.getLogger())
    params["log_to_wandb"] = False
    params["log_to_screen"] = params.get("log_to_screen", False) and world_rank == 0

    if params.get("metadata_json_path", None):
        params, _ = parse_dataset_metadata(params["metadata_json_path"], params=params)
    else:
        raise RuntimeError("Error, please specify a dataset descriptor file in json format")

    from makani_tpu_torch.utils.inferencer import Inferencer

    if args.mode in ("score", "lite"):
        for path in (params.global_means_path, params.global_stds_path):
            if not os.path.exists(path):
                raise FileNotFoundError(path)
        global_means = np.load(params.global_means_path)
        global_stds = np.load(params.global_stds_path)
        output_path = args.inference_output_path
        if not args.overwrite_output_path and os.path.exists(output_path) and world_rank == 0:
            raise FileExistsError(output_path)
        output_channels = list(range(len(params["out_channels"])))
        inferencer = Inferencer(params, device=args.device)

    if args.mode == "score":
        targets, predictions = inferencer.inference_single(
            ic=args.inference_ic, output_data=True, output_channels=output_channels)
        if world_rank != 0:
            return 0
        _write(output_path, _denormalize(predictions, params, global_means, global_stds),
               args.overwrite_output_path)
        _write(args.inference_target_path, _denormalize(targets, params, global_means, global_stds),
               args.overwrite_output_path)
        logging.info(f"predictions saved to {output_path}")
    elif args.mode == "epoch":
        inferencer = Inferencer(params, device=args.device)
        inferencer.score_model(output_channels=params["out_channels"])
    elif args.mode == "lite":
        (predictions,) = inferencer.inference_lite(
            ic=args.inference_ic, output_data=True, output_channels=output_channels)
        if world_rank != 0:
            return 0
        _write(output_path, _denormalize(predictions, params, global_means, global_stds),
               args.overwrite_output_path)
        logging.info(f"predictions saved to {output_path}")
    return 0


if __name__ == "__main__":
    main()
