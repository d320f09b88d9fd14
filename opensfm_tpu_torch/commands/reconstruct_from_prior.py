"""reconstruct_from_prior command shim (reference
commands/reconstruct_from_prior.py)."""

from opensfm_tpu_torch.actions import reconstruct_from_prior
from opensfm_tpu_torch.commands.command import CommandBase


class Command(CommandBase):
    name = "reconstruct_from_prior"
    help = "Reconstruct from prior reconstruction"

    def run_impl(self, dataset, args):
        return reconstruct_from_prior.run_dataset(
            dataset, args.input, args.output, device=args.device)

    def add_arguments(self, parser) -> None:
        parser.add_argument("--input", default="reconstruction.json",
                            help="file name of the prior reconstruction")
        parser.add_argument("--output", default="reconstruction.prior.json",
                            help="file name of the reconstruction to write")
        parser.add_argument(
            "--device", default=None,
            help="torch device to run on (default: cuda; 'cpu' to run on "
            "the CPU)",
        )
