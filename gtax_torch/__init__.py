"""PyTorch + CUDA port of gtax for NVIDIA Hopper (see README.md)."""
