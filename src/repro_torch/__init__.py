"""PyTorch/CUDA port of the CEC routing-and-offloading optimizer.

`repro_torch.core` runs the paper's Algorithm 1 on the sparse edge-slot
engine; its fixed-point recursions and QP projections go through the
hand-written Hopper kernels of `repro_torch.kernels` for tensors on the
card, and through their plain PyTorch versions for tensors on the CPU.
The package imports torch, numpy and scipy only.
"""
