"""CLI commands (argparse shims over actions; reference
`opensfm/commands/__init__.py:33-57`).  The port registers the stages from
images to a reconstruction: `extract_metadata`, `detect_features`,
`match_features`, `create_tracks`, `reconstruct`, `reconstruct_from_prior`,
`extend_reconstruction`, `bundle` and `create_rig`."""

from opensfm_tpu_torch.commands.command import CommandBase  # noqa: F401
from opensfm_tpu_torch.commands.command_runner import command_runner  # noqa: F401


def opensfm_commands():
    from opensfm_tpu_torch.commands import (
        bundle,
        create_rig,
        create_tracks,
        detect_features,
        extend_reconstruction,
        extract_metadata,
        match_features,
        reconstruct,
        reconstruct_from_prior,
    )

    return [extract_metadata.Command(), detect_features.Command(),
            match_features.Command(), create_tracks.Command(),
            reconstruct.Command(), reconstruct_from_prior.Command(),
            bundle.Command(), extend_reconstruction.Command(),
            create_rig.Command()]
