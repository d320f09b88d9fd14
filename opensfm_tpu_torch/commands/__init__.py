"""CLI commands (argparse shims over actions; reference
`opensfm/commands/__init__.py:33-57`).  The port registers `match_features`
and `bundle` so far."""

from opensfm_tpu_torch.commands.command import CommandBase  # noqa: F401
from opensfm_tpu_torch.commands.command_runner import command_runner  # noqa: F401


def opensfm_commands():
    from opensfm_tpu_torch.commands import bundle, match_features

    return [match_features.Command(), bundle.Command()]
