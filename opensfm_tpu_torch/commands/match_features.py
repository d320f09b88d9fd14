"""match_features command shim (reference commands/match_features.py)."""

from opensfm_tpu_torch.actions import match_features
from opensfm_tpu_torch.commands.command import CommandBase


class Command(CommandBase):
    name = "match_features"
    help = "match features"

    def run_impl(self, dataset, args):
        return match_features.run_dataset(dataset, device=args.device)

    def add_arguments(self, parser) -> None:
        parser.add_argument(
            "--device", default=None,
            help="torch device to run on (default: cuda; 'cpu' to run on "
            "the CPU)",
        )
