"""Export the reconstruction in geographic coordinates.

Port of `opensfm_tpu.actions.export_geocoords` (reference
`opensfm/actions/export_geocoords.py`), through the ECEF transform of the
topocentric frame (no pyproj): image positions as latitude, longitude,
altitude, the 4 x 4 transform, or the reconstruction with each point's
`lla`; host code, the same bytes.
"""

from __future__ import annotations

import os

from opensfm_tpu_torch import geo as geo_mod
from opensfm_tpu_torch import io, resolve_device


def run_dataset(
    data, proj: str = "lla", transformation: bool = False,
    image_positions: bool = False, reconstruction: bool = False,
    dense_: bool = False, output: str = None, device=None,
) -> None:
    """Write the exports asked for (image positions when none is); `device`
    is resolved as every entry point resolves it."""
    resolve_device(device)
    reference = data.load_reference()
    if transformation:
        T = geo_mod.ecef_from_topocentric_transform(
            reference.lat, reference.lon, reference.alt
        )
        with open(os.path.join(data.data_path, "geocoords_transformation.txt"), "w") as f:
            for row in T:
                f.write(" ".join(f"{v:.15g}" for v in row) + "\n")
    if image_positions or not (transformation or reconstruction):
        _export_image_positions(data, reference)
    if reconstruction:
        _export_reconstruction_lla(data, reference)


def _export_image_positions(data, reference) -> None:
    recs = data.load_reconstruction()
    rows = ["Image,latitude,longitude,altitude"]
    for rec in recs:
        for shot in rec.shots.values():
            o = shot.pose.get_origin()
            lat, lon, alt = reference.to_lla(*o)
            rows.append(f"{shot.id},{lat:.9f},{lon:.9f},{alt:.3f}")
    with open(os.path.join(data.data_path, "image_geocoords.csv"), "w") as f:
        f.write("\n".join(rows) + "\n")


def _export_reconstruction_lla(data, reference) -> None:
    recs = data.load_reconstruction()
    out = []
    for rec in recs:
        obj = io.reconstruction_to_json(rec)
        for pid, point in rec.points.items():
            lat, lon, alt = reference.to_lla(*point.coordinates)
            obj["points"][pid]["lla"] = [lat, lon, alt]
        out.append(obj)
    with open(os.path.join(data.data_path, "reconstruction.geocoords.json"), "w") as f:
        io.json_dump(out, f)
