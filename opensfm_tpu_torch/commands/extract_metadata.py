"""extract_metadata command shim (reference commands/extract_metadata.py)."""

from opensfm_tpu_torch.actions import extract_metadata
from opensfm_tpu_torch.commands.command import CommandBase


class Command(CommandBase):
    name = "extract_metadata"
    help = "Extract metadata from images' EXIF tag"

    def run_impl(self, dataset, args) -> None:
        # Host work only: --device is accepted, like every command's, and
        # not used.
        extract_metadata.run_dataset(dataset)

    def add_arguments(self, parser) -> None:
        parser.add_argument(
            "--device", default=None,
            help="accepted for a uniform command line and has no effect: "
            "the stage runs on the host",
        )
