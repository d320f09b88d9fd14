"""compute_statistics command shim (reference commands/compute_statistics.py)."""

from opensfm_tpu_torch.actions import compute_statistics
from opensfm_tpu_torch.commands.command import CommandBase


class Command(CommandBase):
    name = "compute_statistics"
    help = "compute statistics"

    def run_impl(self, dataset, args):
        return compute_statistics.run_dataset(dataset, device=args.device)

    def add_arguments(self, parser) -> None:
        parser.add_argument(
            "--device", default=None,
            help="torch device to run on (default: cuda; 'cpu' to run on "
            "the CPU)",
        )
