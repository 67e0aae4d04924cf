"""Host utilities: logging, timing, launch counters, synthetic scenes and the CUDA kernel build."""
