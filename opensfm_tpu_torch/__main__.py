"""`python -m opensfm_tpu_torch <command> <dataset>` — the CLI entry point
(reference bin/opensfm_main.py)."""

from opensfm_tpu_torch.commands import command_runner, opensfm_commands

if __name__ == "__main__":
    command_runner(opensfm_commands)
