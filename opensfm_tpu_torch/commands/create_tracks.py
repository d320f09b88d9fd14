"""create_tracks command shim (reference commands/create_tracks.py)."""

from opensfm_tpu_torch.actions import create_tracks
from opensfm_tpu_torch.commands.command import CommandBase


class Command(CommandBase):
    name = "create_tracks"
    help = "create tracks"

    def run_impl(self, dataset, args) -> None:
        create_tracks.run_dataset(dataset, device=args.device)

    def add_arguments(self, parser) -> None:
        parser.add_argument(
            "--device", default=None,
            help="torch device to run on (default: cuda; 'cpu' to run on "
            "the CPU)",
        )
