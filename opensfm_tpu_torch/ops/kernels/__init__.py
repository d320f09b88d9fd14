"""Hand-written Hopper kernels (sources in `opensfm_tpu_torch/csrc/`), each
beside its plain PyTorch version and a launch counter."""
