"""extend_reconstruction command shim (reference
commands/extend_reconstruction.py): not ported yet, it raises."""

from opensfm_tpu_torch.commands.command import CommandBase


class Command(CommandBase):
    name = "extend_reconstruction"
    help = "extend reconstruction (not ported yet)"

    def run_impl(self, dataset, args) -> None:
        raise NotImplementedError(
            "extend_reconstruction is not ported yet")
