"""detect_features command shim (reference commands/detect_features.py)."""

from opensfm_tpu_torch.actions import detect_features
from opensfm_tpu_torch.commands.command import CommandBase


class Command(CommandBase):
    name = "detect_features"
    help = "Compute features for all images"

    def run_impl(self, dataset, args):
        return detect_features.run_dataset(dataset, device=args.device)

    def add_arguments(self, parser) -> None:
        parser.add_argument(
            "--device", default=None,
            help="torch device to run on (default: cuda; 'cpu' to run on "
            "the CPU)",
        )
