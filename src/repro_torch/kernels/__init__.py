# Serving attention kernels, written by hand for Hopper in CUDA C++
# (csrc/), each beside its plain PyTorch version (ref.py).  ops.py
# dispatches; build.py compiles the sources with nvcc at first use.
# The wrapper modules are named after their kernels, so their functions
# are not re-exported here: import them from ops.
