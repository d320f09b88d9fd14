"""undistort command shim (reference commands/undistort.py)."""

from opensfm_tpu_torch.actions import undistort
from opensfm_tpu_torch.commands.command import CommandBase


class Command(CommandBase):
    name = "undistort"
    help = "Save radially undistorted images"

    def run_impl(self, dataset, args):
        return undistort.run_dataset(
            dataset, args.reconstruction, args.reconstruction_index,
            args.tracks, args.output, args.skip_images, device=args.device)

    def add_arguments(self, parser) -> None:
        parser.add_argument(
            "--reconstruction", default=None,
            help="reconstruction to undistort",
        )
        parser.add_argument(
            "--reconstruction-index", default=0, type=int,
            help="index of the reconstruction component to undistort",
        )
        parser.add_argument(
            "--tracks", default=None,
            help="tracks graph of the reconstruction",
        )
        parser.add_argument(
            "--output", default="undistorted",
            help="output folder",
        )
        parser.add_argument(
            "--skip-images", action="store_true",
            help="skip undistorting the images",
        )
        parser.add_argument(
            "--device", default=None,
            help="torch device to run on (default: cuda; 'cpu' to run on "
            "the CPU)",
        )
