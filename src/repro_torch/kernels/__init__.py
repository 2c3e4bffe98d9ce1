"""Hopper kernels of the sparse engine and of LM attention, their plain
PyTorch versions and the dispatcher (`ops`)."""
