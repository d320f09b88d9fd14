"""Large-scale submodel pipeline: split a dataset into geographic
submodels, reconstruct each, and align them globally.

Port of `opensfm_tpu.large` (reference `opensfm/large/`: metadataset.py,
tools.py).
"""
