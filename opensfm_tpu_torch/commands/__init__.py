"""CLI commands (argparse shims over actions; reference
`opensfm/commands/__init__.py:33-57`).  The port registers the stages from
images to a reconstruction: `extract_metadata`, `detect_features`,
`match_features`, `create_tracks`, `reconstruct`, `reconstruct_from_prior`,
`extend_reconstruction`, `bundle` and `create_rig`, the dense stages
`mesh`, `undistort` and `compute_depthmaps`, with `run_all` running the
eight stages of the reference's `bin/opensfm_run_all`, and the exports
`export_ply`, `export_colmap`, `export_bundler`, `export_visualsfm`,
`export_geocoords`, `export_pmvs` and `export_openmvs`, the submodel
path `create_submodels` and `align_submodels`, and the quality report
`compute_statistics` (stats.json and the figures, drawn without
matplotlib) and `export_report` (stats/report.pdf)."""

from opensfm_tpu_torch.commands.command import CommandBase  # noqa: F401
from opensfm_tpu_torch.commands.command_runner import command_runner  # noqa: F401


def opensfm_commands():
    from opensfm_tpu_torch.commands import (
        align_submodels,
        bundle,
        compute_depthmaps,
        compute_statistics,
        create_rig,
        create_submodels,
        create_tracks,
        detect_features,
        export_bundler,
        export_colmap,
        export_geocoords,
        export_openmvs,
        export_ply,
        export_pmvs,
        export_report,
        export_visualsfm,
        extend_reconstruction,
        extract_metadata,
        match_features,
        mesh,
        reconstruct,
        reconstruct_from_prior,
        run_all,
        undistort,
    )

    return [run_all.Command(), extract_metadata.Command(),
            detect_features.Command(), match_features.Command(),
            create_tracks.Command(), reconstruct.Command(),
            reconstruct_from_prior.Command(), bundle.Command(),
            extend_reconstruction.Command(), mesh.Command(),
            undistort.Command(), compute_depthmaps.Command(),
            export_ply.Command(), export_colmap.Command(),
            export_bundler.Command(), export_visualsfm.Command(),
            export_geocoords.Command(), export_pmvs.Command(),
            export_openmvs.Command(), create_rig.Command(),
            create_submodels.Command(), align_submodels.Command(),
            compute_statistics.Command(), export_report.Command()]
