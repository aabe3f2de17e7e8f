"""Core numeric ops: MLPs, flat message passing and the CUDA kernels."""
