"""The canonical 8-stage pipeline as one command.

The reference's `bin/opensfm_run_all` script (extract_metadata ->
detect_features -> match_features -> create_tracks -> reconstruct -> mesh
-> undistort -> compute_depthmaps) as a subcommand, so
`python -m opensfm_tpu_torch run_all <dataset>` needs no shell wrapper.
"""

from __future__ import annotations

from timeit import default_timer as timer

from opensfm_tpu_torch.commands.command import CommandBase

STAGES = ("extract_metadata", "detect_features", "match_features",
          "create_tracks", "reconstruct", "mesh", "undistort",
          "compute_depthmaps")


class Command(CommandBase):
    name = "run_all"
    help = "Run the full 8-stage pipeline (metadata through depthmaps)"

    def add_arguments(self, parser) -> None:
        parser.add_argument(
            "--device", default=None,
            help="torch device every stage runs on (default: cuda; 'cpu' "
            "to run on the CPU)",
        )

    def run_impl(self, data, args):
        """Run the stages in order on `args.device`; returns {stage:
        {"wall_s": seconds, "report": the stage's own report}}."""
        import importlib

        import torch

        from opensfm_tpu_torch import resolve_device

        dev = resolve_device(args.device)
        report = {}
        for stage in STAGES:
            action = importlib.import_module(
                f"opensfm_tpu_torch.actions.{stage}")
            start = timer()
            if stage == "extract_metadata":  # host work only
                out = action.run_dataset(data)
            else:
                out = action.run_dataset(data, device=dev)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            report[stage] = {"wall_s": timer() - start, "report": out}
        return report
