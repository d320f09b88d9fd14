"""create_submodels command shim (reference commands/create_submodels.py)."""

from opensfm_tpu_torch.actions import create_submodels
from opensfm_tpu_torch.commands.command import CommandBase


class Command(CommandBase):
    name = "create_submodels"
    help = "create submodels"

    def run_impl(self, dataset, args):
        return create_submodels.run_dataset(dataset, device=args.device)

    def add_arguments(self, parser) -> None:
        parser.add_argument(
            "--device", default=None,
            help="torch device to run on (default: cuda; 'cpu' to run on "
            "the CPU)",
        )
