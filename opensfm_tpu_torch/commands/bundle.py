"""bundle command shim (reference commands/bundle.py)."""

from opensfm_tpu_torch.actions import bundle
from opensfm_tpu_torch.commands.command import CommandBase


class Command(CommandBase):
    name = "bundle"
    help = "bundle"

    def run_impl(self, dataset, args):
        return bundle.run_dataset(dataset, device=args.device)

    def add_arguments(self, parser) -> None:
        parser.add_argument(
            "--device", default=None,
            help="torch device to run on (default: cuda; 'cpu' to run on "
            "the CPU)",
        )
