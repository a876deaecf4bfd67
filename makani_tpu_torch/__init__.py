"""PyTorch + CUDA port of makani_tpu for NVIDIA Hopper GPUs.

The package mirrors makani_tpu's module paths (ops/, models/, utils/) so each
counterpart is easy to find. It imports torch and numpy only: nothing of JAX
and nothing of makani_tpu. The coefficient-space contractions of the SFNO run
on hand-written Hopper kernels (makani_tpu_torch/csrc/, wrapped by
ops/spectral_mm.py); the longitude DFT and the 1x1 channel mixes are plain
torch.matmul / torch.bmm, as makani_tpu leaves them to XLA.
"""
