"""export_report command shim (reference commands/export_report.py)."""

from opensfm_tpu_torch.actions import export_report
from opensfm_tpu_torch.commands.command import CommandBase


class Command(CommandBase):
    name = "export_report"
    help = "export report"

    def run_impl(self, dataset, args):
        return export_report.run_dataset(dataset, device=args.device)

    def add_arguments(self, parser) -> None:
        parser.add_argument(
            "--device", default=None,
            help="torch device to run on (default: cuda; 'cpu' to run on "
            "the CPU)",
        )
