"""Logging configuration (counterpart of makani_tpu/utils/logging_utils.py;
`log_versions` logs the torch and CUDA versions)."""

import logging
import os
import subprocess

import torch

_format = "%(asctime)s - %(name)s - %(levelname)s - %(message)s"


def config_logger(log_level=logging.INFO):
    # force=True: the environment may have configured the root logger already
    logging.basicConfig(format=_format, level=log_level, force=True)
    logging.getLogger().setLevel(log_level)


def log_to_file(logger_name=None, log_level=logging.INFO, log_filename="out.log"):
    os.makedirs(os.path.dirname(os.path.abspath(log_filename)), exist_ok=True)
    log = logging.getLogger(logger_name)
    fh = logging.FileHandler(log_filename)
    fh.setLevel(log_level)
    fh.setFormatter(logging.Formatter(_format))
    log.addHandler(fh)


def log_versions():
    logger = logging.getLogger()
    logger.info("--------------- Versions ---------------")
    try:
        branch = subprocess.check_output(
            ["git", "rev-parse", "--abbrev-ref", "HEAD"], stderr=subprocess.DEVNULL).strip().decode()
        commit = subprocess.check_output(
            ["git", "rev-parse", "HEAD"], stderr=subprocess.DEVNULL).strip().decode()
        logger.info("git branch: " + branch)
        logger.info("git hash: " + commit)
    except (OSError, subprocess.CalledProcessError):
        pass  # not a git checkout, or no git
    logger.info("torch: " + torch.__version__)
    logger.info("cuda: " + str(torch.version.cuda))
    logger.info("----------------------------------------")
