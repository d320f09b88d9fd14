"""Synthetic scenes + noisy input synthesis — the hermetic test backbone.

Port of `opensfm_tpu.synthetic_data` (reference `opensfm/synthetic_data/`):
procedural ground-truth reconstructions, noisy EXIF / projection / GCP
generation, an in-memory DataSet and the metrics that grade a
reconstruction against its truth.
"""

from opensfm_tpu_torch.synthetic_data.synthetic_scene import (  # noqa: F401
    SyntheticCubeScene,
    SyntheticInputData,
    SyntheticStreetScene,
    compare,
    get_camera,
    get_scene_generator,
)
from opensfm_tpu_torch.synthetic_data.synthetic_dataset import (  # noqa: F401
    SyntheticDataSet,
)
