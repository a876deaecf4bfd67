"""Checkpoint conversion CLI (counterpart of makani_tpu/convert_legacy_to_flexible.py).

    python3 -m makani_tpu_torch.convert_legacy_to_flexible --input ckpt_mp0.tar \\
        --output DIR --yaml_config config/sfnonet.yaml --config NAME

The port's checkpoints hold whole tensors, restorable on any layout, so the
CLI converts a reference PyTorch Makani checkpoint into the port's format:
tools/convert_torch_checkpoint.py, whose flags it takes.
"""

from makani_tpu_torch.tools.convert_torch_checkpoint import convert, main  # noqa: F401

if __name__ == "__main__":
    main()
