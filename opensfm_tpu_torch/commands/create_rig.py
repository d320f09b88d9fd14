"""create_rig command shim (reference commands/create_rig.py)."""

from opensfm_tpu_torch.actions import create_rig
from opensfm_tpu_torch.commands.command import CommandBase


class Command(CommandBase):
    name = "create_rig"
    help = "Create rig by pattern matching"

    def add_arguments(self, parser) -> None:
        parser.add_argument("method", choices=["camera", "pattern"],
                            help="definition type")
        parser.add_argument("definition",
                            help="JSON dict rig_camera_id -> regex")
        parser.add_argument(
            "--device", default=None,
            help="torch device to run on (default: cuda; 'cpu' to run on "
            "the CPU)",
        )

    def run_impl(self, dataset, args):
        return create_rig.run_dataset(dataset, args.method, args.definition,
                                      device=args.device)
