"""Singleton FeatureLoader instance (port of `opensfm_tpu.feature_loader`)."""

from opensfm_tpu_torch.feature_loading import FeatureLoader

instance = FeatureLoader()
