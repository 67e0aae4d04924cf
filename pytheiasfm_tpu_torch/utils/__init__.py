"""Host utilities: logging and the CUDA kernel build."""
