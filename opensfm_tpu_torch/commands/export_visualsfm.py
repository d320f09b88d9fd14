"""export_visualsfm command shim (reference commands/export_visualsfm.py)."""

from opensfm_tpu_torch.actions import export_visualsfm
from opensfm_tpu_torch.commands.command import CommandBase


class Command(CommandBase):
    name = "export_visualsfm"
    help = "export visualsfm"

    def run_impl(self, dataset, args) -> None:
        export_visualsfm.run_dataset(dataset, device=args.device)

    def add_arguments(self, parser) -> None:
        parser.add_argument(
            "--device", default=None,
            help="torch device to resolve (default: cuda; 'cpu' for the CPU)",
        )
