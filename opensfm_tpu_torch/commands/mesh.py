"""mesh command shim (reference commands/mesh.py)."""

from opensfm_tpu_torch.actions import mesh
from opensfm_tpu_torch.commands.command import CommandBase


class Command(CommandBase):
    name = "mesh"
    help = "Add delaunay meshes to the reconstruction"

    def run_impl(self, dataset, args):
        return mesh.run_dataset(dataset, device=args.device)

    def add_arguments(self, parser) -> None:
        parser.add_argument(
            "--device", default=None,
            help="torch device to resolve (default: cuda; 'cpu' for the "
            "CPU); the triangulation runs on the host",
        )
