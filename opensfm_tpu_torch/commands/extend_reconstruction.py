"""extend_reconstruction command shim (reference
commands/extend_reconstruction.py)."""

from opensfm_tpu_torch.actions import extend_reconstruction
from opensfm_tpu_torch.commands.command import CommandBase


class Command(CommandBase):
    name = "extend_reconstruction"
    help = "Extend a reconstruction with the remaining images"

    def run_impl(self, dataset, args):
        return extend_reconstruction.run_dataset(
            dataset, args.input, args.output, device=args.device)

    def add_arguments(self, parser) -> None:
        parser.add_argument("--input", default=None,
                            help="file name of the reconstruction to extend")
        parser.add_argument("--output", default=None,
                            help="file name of the reconstruction to write")
        parser.add_argument(
            "--device", default=None,
            help="torch device to run on (default: cuda; 'cpu' to run on "
            "the CPU)",
        )
