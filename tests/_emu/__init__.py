"""CPU emulation of the port's CUDA sources (see build.py): a test-time
check of kernel logic on a machine without a GPU."""
