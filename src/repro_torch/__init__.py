"""PyTorch/CUDA port of the ``repro`` serving stack (see README, "PyTorch/CUDA port")."""
