"""Create rigs by filename patterns and calibrate them
(reference actions/create_rig.py)."""

from __future__ import annotations

import json

from opensfm_tpu_torch import rig


def run_dataset(data, method: str = "camera", definition=None,
                device=None) -> None:
    """Group the images into rig instances by `definition` (rig camera id
    -> filename regex, a dict or its JSON) and calibrate the rig cameras by
    reconstructing a subset of the instances on `device` (CUDA unless told
    otherwise); writes `rig_cameras.json` and `rig_assignments.json`.
    `method` is "camera" or "pattern", both grouping by pattern, as in the
    reference."""
    if definition is None:
        raise ValueError("Rig creation requires a pattern definition")
    if isinstance(definition, str):
        definition = json.loads(definition)
    rig.create_rigs_with_pattern(data, definition, device=device)
