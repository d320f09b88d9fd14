"""export_bundler command shim (reference commands/export_bundler.py)."""

from opensfm_tpu_torch.actions import export_bundler
from opensfm_tpu_torch.commands.command import CommandBase


class Command(CommandBase):
    name = "export_bundler"
    help = "export bundler"

    def run_impl(self, dataset, args) -> None:
        export_bundler.run_dataset(dataset, device=args.device)

    def add_arguments(self, parser) -> None:
        parser.add_argument(
            "--device", default=None,
            help="torch device to resolve (default: cuda; 'cpu' for the CPU)",
        )
