"""Multi-page PDF quality report, written without matplotlib.

Port of `opensfm_tpu.report` (reference `opensfm/report.py:16-502`),
section by section and in the same order: title, dataset summary,
processing summary (+ top view), features details (+ heatmaps),
reconstruction details (+ residual histogram), tracks details (+ match
graph), camera models details (+ residual grids), rig cameras details,
processing time details, GPS/GCP errors details.  The section titles, table
headers and cells are the JAX package's strings; the pages are drawn by
`pdf.PdfDocument` (A4, Helvetica, the figures as RGB images read back with
`io.imread`) instead of matplotlib's PdfPages, so the layout differs.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Dict, Optional

from opensfm_tpu_torch import io, pdf

logger = logging.getLogger(__name__)

MARGIN = 50.0  # points, every side
GREEN = (16 / 255.0, 79 / 255.0, 48 / 255.0)  # #104f30
HEADER_FILL = (232 / 255.0, 240 / 255.0, 234 / 255.0)  # #e8f0ea
RULE = (0.85, 0.85, 0.85)
TABLE_SIZE = 9.0  # points
CELL_PAD = 4.0
ROW_H = 1.6  # a table row's height, in font sizes


class Report:
    """Section-by-section report writer (reference report.py:17-502);
    `device` computes the statistics where `stats.json` is absent."""

    def __init__(self, data, stats: Optional[Dict[str, Any]] = None,
                 device=None) -> None:
        self.data = data
        self.device = device
        self.dataset_name = os.path.basename(os.path.normpath(data.data_path))
        self.output_path = os.path.join(data.data_path, "stats")
        if stats is not None:
            self.stats = stats
        else:
            self.stats = self._read_stats_file("stats.json")
        self.doc = pdf.PdfDocument()
        self._y = 0.0

    # -- page and drawing helpers --------------------------------------------
    def _new_page(self) -> None:
        self.doc.new_page()
        self._y = MARGIN

    def add_page_break(self) -> None:
        self._new_page()

    def _ensure_room(self, height: float) -> None:
        if not self.doc.pages or self._y + height > pdf.PAGE_H - MARGIN:
            self._new_page()

    def _text(self, s: str, size: float, bold: bool, color,
              space_after: float) -> None:
        self._ensure_room(size * 1.2 + space_after)
        self._y += size
        self.doc.text(MARGIN, self._y, s, size, bold, color)
        self._y += size * 0.2 + space_after

    def _make_section(self, title: str) -> None:
        self._y += 10.0
        self._text(title, 14, True, GREEN, 8.0)

    def _make_subsection(self, title: str) -> None:
        self._text(title, 11, True, (0.3, 0.3, 0.3), 5.0)

    def _make_table(self, columns_names, rows, row_header=False) -> None:
        """Cells as text runs in ruled boxes: the header row bold on a tint,
        the first column bold with `row_header`; a table wider than the page
        is set in a smaller size."""
        grid = ([[str(c) for c in columns_names]] if columns_names else []) \
            + [[str(c) for c in row] for row in rows]
        if not grid:
            return
        n_cols = max(len(r) for r in grid)

        def bold(r: int, c: int) -> bool:
            return bool((columns_names and r == 0) or (row_header and c == 0))

        natural = [0.0] * n_cols
        for r, row in enumerate(grid):
            for c, cell in enumerate(row):
                natural[c] = max(natural[c],
                                 pdf.text_width(cell, TABLE_SIZE, bold(r, c)))
        room = pdf.PAGE_W - 2 * MARGIN
        size = TABLE_SIZE
        if sum(natural) + 2 * CELL_PAD * n_cols > room:
            size = TABLE_SIZE * (room - 2 * CELL_PAD * n_cols) / sum(natural)
        widths = [w * size / TABLE_SIZE + 2 * CELL_PAD for w in natural]
        row_h = size * ROW_H
        self._ensure_room(row_h * len(grid) + 12.0)
        top = self._y
        if columns_names:
            self.doc.rect(MARGIN, top, sum(widths), row_h, HEADER_FILL)
        for r, row in enumerate(grid):
            x = MARGIN
            baseline = top + r * row_h + (row_h + size * 0.7) / 2.0
            for c, cell in enumerate(row):
                self.doc.text(x + CELL_PAD, baseline, cell, size, bold(r, c),
                              (0.1, 0.1, 0.1))
                x += widths[c]
        bottom = top + row_h * len(grid)
        for r in range(len(grid) + 1):
            y = top + r * row_h
            self.doc.line(MARGIN, y, MARGIN + sum(widths), y, 0.5, RULE)
        x = MARGIN
        for w in [0.0] + widths:
            x += w
            self.doc.line(x, top, x, bottom, 0.5, RULE)
        self._y = bottom + 12.0

    def _make_centered_image(self, image_path: str, desired_height: float) -> None:
        """desired_height in the reference's mm units (page = 297 mm)."""
        if not os.path.isfile(image_path):
            return
        pixels = io.imread(image_path)
        h_px, w_px = pixels.shape[:2]
        height = min(desired_height / 297.0, 0.75) * pdf.PAGE_H
        width = height * w_px / h_px
        room = pdf.PAGE_W - 2 * MARGIN
        if width > room:
            width, height = room, room * h_px / w_px
        self._ensure_room(height + 12.0)
        self.doc.image(pixels, (pdf.PAGE_W - width) / 2.0, self._y, width,
                       height)
        self._y += height + 12.0

    def _read_stats_file(self, filename: str) -> Dict[str, Any]:
        path = os.path.join(self.output_path, filename)
        if not os.path.isfile(path):
            from opensfm_tpu_torch.actions import compute_statistics

            compute_statistics.run_dataset(self.data, device=self.device)
        with open(path) as f:
            return json.load(f)

    # -- sections (reference report.py order) --------------------------------
    def make_title(self) -> None:
        self._new_page()
        title = "OpenSfM Quality Report"
        self.doc.text((pdf.PAGE_W - pdf.text_width(title, 20, True)) / 2.0,
                      MARGIN + 20, title, 20, True, GREEN)
        note = "Processed with OpenSfM-TPU"
        self.doc.text(pdf.PAGE_W - MARGIN - pdf.text_width(note, 8),
                      MARGIN + 40, note, 8, False, (0.4, 0.4, 0.4))
        self._y = MARGIN + 64

    def make_dataset_summary(self) -> None:
        self._make_section("Dataset Summary")
        ps = self.stats.get("processing_statistics", {})
        rows = [
            ["Dataset", self.dataset_name],
            ["Date", ps.get("date", "unknown")],
            ["Area Covered", f"{ps.get('area', 0) / 1e6:.6f} km²"],
            [
                "Processing Time",
                f"{ps.get('steps_times', {}).get('Total Time', 0):.2f} seconds",
            ],
        ]
        self._make_table(None, rows, True)

    def _has_meaningful_gcp(self) -> bool:
        return bool(
            self.stats.get("reconstruction_statistics", {}).get("has_gcp")
            and "average_error" in self.stats.get("gcp_errors", {})
        )

    def make_processing_summary(self) -> None:
        self._make_section("Processing Summary")
        rs = self.stats.get("reconstruction_statistics", {})
        fs = self.stats.get("features_statistics", {})
        rec_shots = rs.get("reconstructed_shots_count", 0)
        init_shots = rs.get("initial_shots_count", 0)
        rec_points = rs.get("reconstructed_points_count", 0)
        init_points = max(rs.get("initial_points_count", 0), 1)
        geo_string = []
        if rs.get("has_gps"):
            geo_string.append("GPS")
        if self._has_meaningful_gcp():
            geo_string.append("GCP")
        ratio_shots = rec_shots / init_shots * 100 if init_shots > 0 else -1
        rows = [
            ["Reconstructed Images",
             f"{rec_shots} over {init_shots} shots ({ratio_shots:.1f}%)"],
            ["Reconstructed Points",
             f"{rec_points} over {init_points} points "
             f"({rec_points / init_points * 100:.1f}%)"],
            ["Reconstructed Components",
             f"{rs.get('components', 1)} component"],
            ["Detected Features",
             f"{fs.get('detected_features', {}).get('median', -1)} features"],
            ["Reconstructed Features",
             f"{fs.get('reconstructed_features', {}).get('median', -1)} features"],
            ["Geographic Reference", " and ".join(geo_string)],
        ]
        geo_errors = []
        if rs.get("has_gps") and "average_error" in self.stats.get("gps_errors", {}):
            geo_errors.append(f"{self.stats['gps_errors']['average_error']:.2f}")
        if self._has_meaningful_gcp():
            geo_errors.append(f"{self.stats['gcp_errors']['average_error']:.2f}")
        rows.append(
            [" / ".join(geo_string) + " errors",
             " / ".join(geo_errors) + " meters" if geo_errors else "-"]
        )
        self._make_table(None, rows, True)
        self._make_centered_image(
            os.path.join(self.output_path, "topview.png"), 130
        )

    def make_processing_time_details(self) -> None:
        self._make_section("Processing Time Details")
        steps = self.stats.get("processing_statistics", {}).get("steps_times", {})
        if steps:
            names = list(steps.keys())
            values = [f"{v:.2f} sec." for v in steps.values()]
            self._make_table(names, [values])

    def make_gps_details(self) -> None:
        self._make_section("GPS/GCP Errors Details")
        for error_type, title in (("gps", "GPS"), ("gcp", "GCP")):
            errors = self.stats.get(f"{error_type}_errors", {})
            if not errors or "mean" not in errors:
                continue
            self._make_subsection(f"{title} Errors")
            rows = []
            names = ["", "Mean", "Sigma", "RMS Error"]
            for comp in ("x", "y", "z"):
                rows.append([
                    comp.upper(),
                    f"{errors['mean'].get(comp, 0):.3f}",
                    f"{errors['std'].get(comp, 0):.3f}",
                    f"{errors['error'].get(comp, 0):.3f}",
                ])
            self._make_table(names, rows)
            if "ce90" in errors:
                rows = [[
                    f"{errors.get('average_error', 0):.3f} m",
                    f"{errors.get('ce90', 0):.3f} m",
                    f"{errors.get('le90', 0):.3f} m",
                ]]
                self._make_table(
                    ["Average Error", "CE90", "LE90"], rows
                )

    def make_features_details(self) -> None:
        self._make_section("Features Details")
        fs = self.stats.get("features_statistics", {})
        heatmaps = sorted(
            f for f in os.listdir(self.output_path)
            if f.startswith("heatmap_") and f.endswith(".png")
        ) if os.path.isdir(self.output_path) else []
        if fs:
            rows = []
            for name, key in (("Detected Features", "detected_features"),
                              ("Reconstructed Features", "reconstructed_features")):
                d = fs.get(key, {})
                rows.append([
                    name,
                    str(d.get("min", -1)), str(d.get("max", -1)),
                    f"{d.get('mean', -1):.0f}", str(d.get("median", -1)),
                ])
            self._make_table(["", "Min", "Max", "Mean", "Median"], rows)
        for name in heatmaps[:4]:
            self._make_centered_image(
                os.path.join(self.output_path, name), 110
            )

    def make_reconstruction_details(self) -> None:
        self._make_section("Reconstruction Details")
        rs = self.stats.get("reconstruction_statistics", {})
        rows = [
            ["Average Reprojection Error (normalized / pixels / angular)",
             f"{rs.get('reprojection_error_normalized', -1):.4f} / "
             f"{rs.get('reprojection_error_pixels', -1):.2f} px / "
             f"{rs.get('reprojection_error_angular', -1):.5f}"],
            ["Average Track Length",
             f"{rs.get('average_track_length', -1):.2f} images"],
            ["Average Track Length (> 2)",
             f"{rs.get('average_track_length_over_two', -1):.2f} images"],
        ]
        self._make_table(None, rows, True)
        self._make_centered_image(
            os.path.join(self.output_path, "residual_histogram.png"), 110
        )

    def make_camera_models_details(self) -> None:
        self._make_section("Camera Models Details")
        cs = self.stats.get("camera_errors", {})
        for camera, errors in cs.items():
            self._make_subsection(camera)
            names = list(errors.get("initial_values", {}).keys())
            rows = []
            for key in ("initial_values", "optimized_values"):
                d = errors.get(key, {})
                rows.append([f"{d.get(n, 0):.4f}" for n in names])
            if names:
                self._make_table(names, rows)
        grids = sorted(
            f for f in os.listdir(self.output_path)
            if f.startswith("residuals_") and f.endswith(".png")
        ) if os.path.isdir(self.output_path) else []
        for name in grids:
            self._make_centered_image(
                os.path.join(self.output_path, name), 120
            )

    def make_rig_cameras_details(self) -> None:
        rigs = self.stats.get("rig_errors", {})
        if not rigs:
            return
        self._make_section("Rig Cameras Details")
        for rig_camera_id, errors in rigs.items():
            self._make_subsection(rig_camera_id)
            for key, title in (("initial_values", "Initial"),
                               ("optimized_values", "Optimized")):
                d = errors.get(key)
                if not d:
                    continue
                rows = [[
                    title,
                    str([round(v, 4) for v in d.get("rotation", [])]),
                    str([round(v, 4) for v in d.get("translation", [])]),
                ]]
                self._make_table(["", "Rotation", "Translation"], rows)

    def make_tracks_details(self) -> None:
        self._make_section("Tracks Details")
        rs = self.stats.get("reconstruction_statistics", {})
        histo = rs.get("histogram_track_length", {})
        if histo:
            lengths = sorted(histo.keys(), key=lambda x: int(x))[:10]
            self._make_table(
                ["Length"] + [str(l) for l in lengths],
                [["Count"] + [str(histo[l]) for l in lengths]],
            )
        self._make_centered_image(
            os.path.join(self.output_path, "matchgraph.png"), 110
        )

    def generate_report(self) -> None:
        self.make_title()
        self.make_dataset_summary()
        self.make_processing_summary()
        self.add_page_break()
        self.make_features_details()
        self.make_reconstruction_details()
        self.add_page_break()
        self.make_tracks_details()
        self.make_camera_models_details()
        self.make_rig_cameras_details()
        self.add_page_break()
        self.make_processing_time_details()
        self.make_gps_details()

    def save_report(self, filename: str = "report.pdf") -> None:
        out_file = os.path.join(self.output_path, filename)
        os.makedirs(self.output_path, exist_ok=True)
        self.doc.save(out_file)
        logger.info("Report written to %s", out_file)


def generate_report(data, device=None) -> None:
    """Entry point used by export_report (reference actions/export_report)."""
    report = Report(data, device=device)
    report.generate_report()
    report.save_report("report.pdf")
