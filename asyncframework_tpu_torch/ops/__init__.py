"""Step layer: gradients, sampling, steps, and the CUDA kernels."""
