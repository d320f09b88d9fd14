"""CLI commands (argparse shims over actions; reference
`opensfm/commands/__init__.py:33-57`).  The port registers `match_features`,
`create_tracks`, `reconstruct` and `bundle` so far; `reconstruct_from_prior`
and `extend_reconstruction` are registered and raise NotImplementedError."""

from opensfm_tpu_torch.commands.command import CommandBase  # noqa: F401
from opensfm_tpu_torch.commands.command_runner import command_runner  # noqa: F401


def opensfm_commands():
    from opensfm_tpu_torch.commands import (
        bundle,
        create_tracks,
        extend_reconstruction,
        match_features,
        reconstruct,
        reconstruct_from_prior,
    )

    return [match_features.Command(), create_tracks.Command(),
            reconstruct.Command(), reconstruct_from_prior.Command(),
            bundle.Command(), extend_reconstruction.Command()]
