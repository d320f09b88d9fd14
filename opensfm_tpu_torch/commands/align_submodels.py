"""align_submodels command shim (reference commands/align_submodels.py)."""

from opensfm_tpu_torch.actions import align_submodels
from opensfm_tpu_torch.commands.command import CommandBase


class Command(CommandBase):
    name = "align_submodels"
    help = "align submodels"

    def run_impl(self, dataset, args):
        return align_submodels.run_dataset(dataset, device=args.device)

    def add_arguments(self, parser) -> None:
        parser.add_argument(
            "--device", default=None,
            help="torch device to run on (default: cuda; 'cpu' to run on "
            "the CPU)",
        )
