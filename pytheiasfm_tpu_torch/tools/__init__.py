"""Scenes and measuring scripts for the port's slices (run on a CUDA card)."""
