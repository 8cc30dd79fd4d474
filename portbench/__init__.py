"""The benchmark of ofa_sr_tpu_torch, the PyTorch and CUDA port (README.md)."""
