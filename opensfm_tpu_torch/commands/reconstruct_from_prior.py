"""reconstruct_from_prior command shim (reference
commands/reconstruct_from_prior.py): not ported yet, it raises."""

from opensfm_tpu_torch.commands.command import CommandBase


class Command(CommandBase):
    name = "reconstruct_from_prior"
    help = "reconstruct from prior (not ported yet)"

    def run_impl(self, dataset, args) -> None:
        raise NotImplementedError(
            "reconstruct_from_prior is not ported yet")
