"""PyTorch/CUDA port of the CEC routing-and-offloading optimizer.

`repro_torch.core` runs the paper's Algorithm 1 on the sparse edge-slot
engine; `repro_torch.models`, `serving` and `launch.serve` serve the
dense, MoE, Mamba2 (SSM) and hybrid LM families.  Their kernels
(`repro_torch.kernels`) are hand-written Hopper kernels for tensors on
the card and plain PyTorch versions for tensors on the CPU.  The
package imports torch, numpy and scipy only.
"""
