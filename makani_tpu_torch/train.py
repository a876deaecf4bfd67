"""Training CLI (counterpart of makani_tpu/train.py).

    python3 -m makani_tpu_torch.train --yaml_config config/sfnonet.yaml \\
        --config NAME [--amp_mode bf16] [--mode train|test] [--device cuda|cpu] ...

`--mode train` trains the config (validation, per-epoch and best checkpoints
under <exp_dir>/<config>/<run_num>/training_checkpoints) and resumes from
the per-epoch checkpoint when one is there; `--mode test` runs the DebugNet
pipeline self-test on the config's data. The flags are makani_tpu's, plus
--device (default cuda; without CUDA it raises unless --device cpu).
makani_tpu's no-op flags (--jit_mode, --cuda_graph_mode, --disable_ddp,
--parameters_reduction_buffer_count) are accepted and change nothing.
--multistep_count K trains the K-step unroll (n_future = K - 1). A config's
`log_video` renders the rollout videos (utils/visualize; matplotlib and PIL
on the host). The port runs one process on one device: a *_parallel_size
other than 1 is refused (ROADMAP, Queue 1 item 7); --split_data_channels, a
mesh setting, changes nothing.
"""

import argparse
import logging
import os

from makani_tpu_torch.utils import logging_utils
from makani_tpu_torch.utils.checkpoint import checkpoint_exists
from makani_tpu_torch.utils.dataset_metadata import parse_dataset_metadata
from makani_tpu_torch.utils.device import resolve_device
from makani_tpu_torch.utils.yparams import YParams


def _parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--fin_parallel_size", default=1, type=int,
                        help="Input feature paralellization")
    parser.add_argument("--fout_parallel_size", default=1, type=int,
                        help="Output feature paralellization")
    parser.add_argument("--h_parallel_size", default=1, type=int,
                        help="Spatial parallelism dimension in h")
    parser.add_argument("--w_parallel_size", default=1, type=int,
                        help="Spatial parallelism dimension in w")
    parser.add_argument("--run_num", default="00", type=str)
    parser.add_argument("--yaml_config", default="./config/sfnonet.yaml", type=str)
    parser.add_argument("--config", default="base_73chq", type=str)
    parser.add_argument("--batch_size", default=-1, type=int, help="Override global batch size")
    parser.add_argument("--enable_synthetic_data", action="store_true")
    parser.add_argument("--amp_mode", default="none", type=str, choices=["none", "fp16", "bf16"])
    parser.add_argument("--checkpointing_level", default=0, type=int,
                        help="How aggressively activation checkpointing is used")
    parser.add_argument("--print_timings_frequency", default=-1, type=int)
    parser.add_argument("--skip_validation", action="store_true")
    parser.add_argument("--mode", default="train", type=str, choices=["train", "test"])
    parser.add_argument("--profile", default=0, type=int,
                        help="torch.profiler trace of the first N training steps, written "
                             "to <experiment dir>/profile/trace.json")
    parser.add_argument("--save_checkpoint", default="flexible",
                        choices=["none", "flexible", "legacy"], type=str)
    parser.add_argument("--load_checkpoint", default="flexible", choices=["flexible", "legacy"],
                        type=str)
    parser.add_argument("--multistep_count", default=1, type=int)
    parser.add_argument("--enable_odirect", action="store_true",
                        help="O_DIRECT reads in the native reader")
    parser.add_argument("--enable_benchy", action="store_true",
                        help="Wrap the train loader in a throughput benchmark")
    parser.add_argument("--enable_grad_anomaly_detection", action="store_true",
                        help="torch.autograd.set_detect_anomaly in the training step")
    parser.add_argument("--split_data_channels", action="store_true")
    parser.add_argument("--epsilon_factor", default=0, type=float,
                        help="Optimizer eps = 1e-8 * 10**epsilon_factor")
    # makani_tpu's no-op flags, accepted for its command lines
    parser.add_argument("--jit_mode", default="none", type=str, help="no-op")
    parser.add_argument("--cuda_graph_mode", default="none", type=str, help="no-op")
    parser.add_argument("--disable_ddp", action="store_true", help="no-op")
    parser.add_argument("--parameters_reduction_buffer_count", default=1, type=int, help="no-op")
    parser.add_argument("--device", default="cuda", type=str, choices=["cuda", "cpu"])
    return parser


def main(argv=None):
    """Runs the CLI; returns the Trainer."""
    args = _parser().parse_args(argv)
    resolve_device(args.device)  # no CUDA: raise before anything is written
    sizes = [args.h_parallel_size, args.w_parallel_size, args.fin_parallel_size,
             args.fout_parallel_size]
    if any(s != 1 for s in sizes):
        raise NotImplementedError(f"model parallelism (h, w, fin, fout sizes {sizes}) is not "
                                  "ported yet (ROADMAP: Queue 1 item 7)")

    params = YParams(os.path.abspath(args.yaml_config), args.config)
    params["fin_parallel_size"] = args.fin_parallel_size
    params["fout_parallel_size"] = args.fout_parallel_size
    params["h_parallel_size"] = args.h_parallel_size
    params["w_parallel_size"] = args.w_parallel_size
    params["model_parallel_sizes"] = sizes
    params["model_parallel_names"] = ["h", "w", "fin", "fout"]
    params["load_checkpoint"] = args.load_checkpoint
    params["save_checkpoint"] = args.save_checkpoint
    params["world_size"] = 1
    if args.batch_size > 0:
        params.batch_size = args.batch_size
    params["global_batch_size"] = params.batch_size
    if "optimizer_max_grad_norm" not in params:
        params["optimizer_max_grad_norm"] = 1.0

    exp_dir = os.path.join(params.exp_dir, args.config, str(args.run_num))
    os.makedirs(os.path.join(exp_dir, "training_checkpoints"), exist_ok=True)
    params["experiment_dir"] = os.path.abspath(exp_dir)
    params["checkpoint_path"] = os.path.join(exp_dir, "training_checkpoints", "ckpt")
    params["best_checkpoint_path"] = os.path.join(exp_dir, "training_checkpoints", "best_ckpt")
    # resume where a per-epoch checkpoint is there
    params["resuming"] = checkpoint_exists(params["checkpoint_path"])

    params["amp_mode"] = args.amp_mode
    params["skip_validation"] = args.skip_validation
    params["checkpointing"] = args.checkpointing_level
    params["enable_synthetic_data"] = args.enable_synthetic_data
    params["print_timings_frequency"] = args.print_timings_frequency
    params["multistep_count"] = args.multistep_count
    params["n_future"] = args.multistep_count - 1
    params["profile_steps"] = args.profile
    params["enable_odirect"] = args.enable_odirect
    params["enable_benchy"] = args.enable_benchy
    params["enable_grad_anomaly_detection"] = args.enable_grad_anomaly_detection
    params["split_data_channels"] = args.split_data_channels
    params["epsilon_factor"] = args.epsilon_factor

    logging_utils.config_logger()
    logging_utils.log_to_file(logger_name=None, log_filename=os.path.join(exp_dir, "out.log"))
    logging_utils.log_versions()
    params.log(logging.getLogger())
    params["log_to_wandb"] = params.get("log_to_wandb", False)
    params["log_to_screen"] = params.get("log_to_screen", False)

    if params.get("metadata_json_path", None):
        params, _ = parse_dataset_metadata(params["metadata_json_path"], params=params)
    else:
        raise RuntimeError("Error, please specify a dataset descriptor file in json format")

    from makani_tpu_torch.utils.trainer import Trainer

    if args.mode == "train":
        trainer = Trainer(params, device=args.device)
        trainer.train()
    else:
        params["nettype"] = "DebugNet"
        trainer = Trainer(params, device=args.device)
        trainer.test_autoregression_pipeline()
    return trainer


if __name__ == "__main__":
    main()
