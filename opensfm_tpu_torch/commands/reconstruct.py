"""reconstruct command shim (reference commands/reconstruct.py)."""

from opensfm_tpu_torch.actions import reconstruct
from opensfm_tpu_torch.commands.command import CommandBase


class Command(CommandBase):
    name = "reconstruct"
    help = "Compute the reconstruction"

    def add_arguments(self, parser) -> None:
        parser.add_argument(
            "--algorithm",
            choices=["incremental", "triangulation"],
            default="incremental",
            help="reconstruction algorithm",
        )
        parser.add_argument(
            "--device", default=None,
            help="torch device to run on (default: cuda; 'cpu' to run on "
            "the CPU)",
        )

    def run_impl(self, dataset, args):
        return reconstruct.run_dataset(dataset, args.algorithm,
                                       device=args.device)
