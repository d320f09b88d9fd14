"""Align submodel reconstructions (reference
actions/align_submodels.py:6-14): the pose-graph alignment of every
submodel's partial reconstructions, written to each submodel's
`reconstruction.aligned.json`."""

from opensfm_tpu_torch import resolve_device
from opensfm_tpu_torch.large import tools
from opensfm_tpu_torch.large.metadataset import MetaDataSet


def run_dataset(data, device=None) -> dict:
    """Align and apply; returns the alignment solve's report (seconds,
    steps, costs, Jacobian shape) with the number of partials."""
    device = resolve_device(device)
    meta_data = MetaDataSet(data.data_path)
    reconstruction_shots = tools.load_reconstruction_shots(meta_data)
    report = {"partials": len(reconstruction_shots)}
    transformations = tools.align_reconstructions(
        reconstruction_shots, tools.partial_reconstruction_name, True,
        device=device, report=report,
    )
    tools.apply_transformations(transformations)
    return report
