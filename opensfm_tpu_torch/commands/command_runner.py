"""Subcommand dispatch (reference commands/command_runner.py:10-46)."""

from __future__ import annotations

import argparse
import logging
from typing import List, Optional


def command_runner(all_commands_types, dataset_factory=None,
                   argv: Optional[List[str]] = None):
    """Parse `argv` (default: the process arguments), run the chosen
    command on its dataset and return the command's result."""
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s: %(message)s",
    )
    parser = argparse.ArgumentParser(
        description="opensfm_tpu_torch — structure from motion on PyTorch/CUDA"
    )
    subparsers = parser.add_subparsers(dest="command", help="Command to run")
    subparsers.required = True

    commands = (
        all_commands_types() if callable(all_commands_types) else all_commands_types
    )
    for command in commands:
        subparser = subparsers.add_parser(command.name, help=command.help)
        subparser.add_argument("dataset", help="dataset to process")
        command.add_arguments(subparser)

    args = parser.parse_args(argv)

    if dataset_factory is None:
        from opensfm_tpu_torch.dataset import DataSet

        def dataset_factory(a):
            return DataSet(a.dataset)

    for command in commands:
        if args.command == command.name:
            return command.run(dataset_factory(args), args)
    return None
