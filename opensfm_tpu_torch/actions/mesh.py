"""Add Delaunay meshes to the reconstruction (reference actions/mesh.py)."""

from __future__ import annotations

from timeit import default_timer as timer
from typing import Any, Dict

from opensfm_tpu_torch import mesh, resolve_device


def run_dataset(data, device=None) -> Dict[str, Any]:
    """Give every shot of `data`'s reconstructions its mesh and write
    `reconstruction.meshed.json`; return the report (shots, faces).  The
    triangulation is scipy's on the host: `device` is resolved as every
    entry point resolves it (CUDA unless told otherwise, raising when CUDA
    is absent), though no step of this stage runs on it."""
    dev = resolve_device(device)
    start = timer()
    tracks_manager = data.load_tracks_manager()
    reconstructions = data.load_reconstruction()
    all_shot_ids = set(tracks_manager.get_shot_ids())
    faces = {}
    for r in reconstructions:
        for shot in r.shots.values():
            if shot.id in all_shot_ids:
                vertices, shot_faces = mesh.triangle_mesh(shot.id, r,
                                                          tracks_manager)
                shot.mesh.vertices = vertices
                shot.mesh.faces = shot_faces
                faces[shot.id] = len(shot_faces)
    data.save_reconstruction(reconstructions,
                             filename="reconstruction.meshed.json",
                             minify=True)
    return {"device": str(dev), "shots": len(faces),
            "faces_min": min(faces.values(), default=0),
            "faces_total": sum(faces.values()), "wall_s": timer() - start}
