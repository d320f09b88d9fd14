"""compute_depthmaps command shim (reference commands/compute_depthmaps.py)."""

from opensfm_tpu_torch.actions import compute_depthmaps
from opensfm_tpu_torch.commands.command import CommandBase


class Command(CommandBase):
    name = "compute_depthmaps"
    help = "Compute depthmaps"

    def run_impl(self, dataset, args):
        return compute_depthmaps.run_dataset(
            dataset, args.subfolder, args.interactive, device=args.device)

    def add_arguments(self, parser) -> None:
        parser.add_argument(
            "--subfolder", default="undistorted",
            help="undistorted subfolder where to load and store data",
        )
        parser.add_argument(
            "--interactive", action="store_true",
            help="plot results as they are being computed",
        )
        parser.add_argument(
            "--device", default=None,
            help="torch device to run on (default: cuda; 'cpu' to run on "
            "the CPU)",
        )
