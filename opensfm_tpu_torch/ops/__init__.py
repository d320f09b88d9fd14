"""Device math: small linear algebra and the hand-written CUDA kernels."""
