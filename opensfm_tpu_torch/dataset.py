"""Filesystem dataset: the on-disk layout every pipeline stage talks to.

Mirrors reference `opensfm/dataset.py` (DataSet:25, UndistortedDataSet:716)
and the inter-stage file contract of SURVEY.md §2.3: images/, exif/,
features/, matches/, tracks.csv, reconstruction.json, reference_lla.json,
camera models, rigs, GCPs, reports, undistorted/.
"""

from __future__ import annotations

import glob
import gzip
import json
import logging
import os
import pickle
from io import BytesIO
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from opensfm_tpu_torch import config as config_mod
from opensfm_tpu_torch import geo, io, pymap, types
from opensfm_tpu_torch.dataset_base import DataSetBase
from opensfm_tpu_torch.features import FeaturesData

logger = logging.getLogger(__name__)


def _grey_png(path: str) -> Optional[np.ndarray]:
    """A mask or segmentation PNG's grey pixels, None where there is none."""
    if os.path.isfile(path):
        return io.imread(path, grayscale=True)
    return None


def _image_files(directory: str) -> Dict[str, str]:
    files = {}
    if os.path.isdir(directory):
        for entry in os.listdir(directory):
            ext = entry.split(".")[-1].lower()
            if ext in io.IMAGE_EXTENSIONS:
                files[entry] = os.path.join(directory, entry)
    return files


class DataSet(DataSetBase):
    """Accessors for a dataset rooted at a directory (dataset.py:25)."""

    def __init__(self, data_path: str) -> None:
        self.data_path = data_path
        self.config = config_mod.load_config(self._fp("config.yaml"))
        self._image_list: List[str] = []
        self._image_files: Dict[str, str] = {}
        self._set_image_path(self._fp("images"))

    # -- paths --------------------------------------------------------------
    def _fp(self, *parts: str) -> str:
        return os.path.join(self.data_path, *parts)

    def _ensure_dir(self, *parts: str) -> str:
        path = self._fp(*parts)
        os.makedirs(path, exist_ok=True)
        return path

    # -- images -------------------------------------------------------------
    def _set_image_path(self, path: str) -> None:
        list_file = self._fp("image_list.txt")
        if os.path.isfile(list_file):
            with open(list_file) as f:
                paths = [line.strip() for line in f if line.strip()]
            self._image_files = {
                os.path.basename(p): os.path.join(self.data_path, p) for p in paths
            }
        else:
            self._image_files = _image_files(path)
        self._image_list = sorted(self._image_files)

    def images(self) -> List[str]:
        return self._image_list

    def image_file(self, image: str) -> str:
        return self._image_files[image]

    def load_image(self, image: str, unchanged: bool = False, anydepth: bool = False,
                   grayscale: bool = False) -> np.ndarray:
        """The image's pixels (RGB unless `grayscale` or `unchanged`):
        PNG and PGM/PPM decoded by the port, other formats through cv2 or
        PIL (`io.imread`)."""
        return io.imread(self.image_file(image), grayscale=grayscale,
                         unchanged=unchanged, anydepth=anydepth)

    def image_size(self, image: str) -> Tuple[int, int]:
        return io.image_size(self.image_file(image))

    # -- masks / segmentation -------------------------------------------------
    def _grey_png(self, folder: str, image: str) -> Optional[np.ndarray]:
        return _grey_png(self._fp(folder, image + ".png"))

    def load_mask(self, image: str) -> Optional[np.ndarray]:
        return self._grey_png("masks", image)

    def load_features_mask(self, image: str, points: np.ndarray) -> np.ndarray:
        from opensfm_tpu_torch import masking

        return masking.load_features_mask(self, image, points)

    def load_segmentation(self, image: str) -> Optional[np.ndarray]:
        return self._grey_png("segmentations", image)

    def load_instances(self, image: str) -> Optional[np.ndarray]:
        return self._grey_png("instances", image)

    def segmentation_labels(self) -> List[Any]:
        return []

    # -- exif ----------------------------------------------------------------
    def _exif_path(self, image: str) -> str:
        return self._fp("exif", image + ".exif")

    def exif_exists(self, image: str) -> bool:
        return os.path.isfile(self._exif_path(image))

    def load_exif(self, image: str) -> Dict[str, Any]:
        with open(self._exif_path(image)) as f:
            return json.load(f)

    def save_exif(self, image: str, data: Dict[str, Any]) -> None:
        self._ensure_dir("exif")
        with open(self._exif_path(image), "w") as f:
            io.json_dump(data, f)

    def extract_exif(self, image: str) -> Dict[str, Any]:
        from opensfm_tpu_torch import exif as exif_mod

        with open(self.image_file(image), "rb") as f:
            return exif_mod.extract_exif_from_file(
                f, lambda: self.image_size(image),
                self.config["use_exif_size"], name=image,
            )

    # -- camera models --------------------------------------------------------
    def load_camera_models(self) -> Dict[str, Any]:
        with open(self._fp("camera_models.json")) as f:
            return io.cameras_from_json(json.load(f))

    def save_camera_models(self, camera_models: Dict[str, Any]) -> None:
        with open(self._fp("camera_models.json"), "w") as f:
            io.json_dump(io.cameras_to_json(camera_models), f)

    def load_camera_models_overrides(self) -> Dict[str, Any]:
        path = self._fp("camera_models_overrides.json")
        if os.path.isfile(path):
            with open(path) as f:
                return io.cameras_from_json(json.load(f))
        return {}

    def camera_models_overrides_exists(self) -> bool:
        return os.path.isfile(self._fp("camera_models_overrides.json"))

    def load_exif_overrides(self) -> Dict[str, Any]:
        path = self._fp("exif_overrides.json")
        if os.path.isfile(path):
            with open(path) as f:
                return json.load(f)
        return {}

    def exif_overrides_exists(self) -> bool:
        return os.path.isfile(self._fp("exif_overrides.json"))

    # -- features -------------------------------------------------------------
    def _feature_path(self, image: str) -> str:
        return self._fp("features", image + ".features.npz")

    def features_exist(self, image: str) -> bool:
        return os.path.isfile(self._feature_path(image))

    def load_features(self, image: str) -> Optional[FeaturesData]:
        if not self.features_exist(image):
            return None
        return FeaturesData.from_file(self._feature_path(image), self.config)

    def save_features(self, image: str, features_data: FeaturesData) -> None:
        self._ensure_dir("features")
        features_data.save(self._feature_path(image), self.config)

    # -- words ---------------------------------------------------------------
    def _words_path(self, image: str) -> str:
        return self._fp("features", image + ".words.npz")

    def words_exist(self, image: str) -> bool:
        return os.path.isfile(self._words_path(image))

    def load_words(self, image: str) -> np.ndarray:
        return np.load(self._words_path(image))["words"]

    def save_words(self, image: str, words: np.ndarray) -> None:
        self._ensure_dir("features")
        np.savez_compressed(self._words_path(image), words=words.astype(np.uint16))

    # -- matches --------------------------------------------------------------
    def _matches_path(self, image: str) -> str:
        return self._fp("matches", image + "_matches.pkl.gz")

    def matches_exists(self, image: str) -> bool:
        return os.path.isfile(self._matches_path(image))

    def load_matches(self, image: str) -> Dict[str, np.ndarray]:
        with gzip.open(self._matches_path(image), "rb") as f:
            return pickle.load(f)

    def save_matches(self, image: str, matches: Dict[str, np.ndarray]) -> None:
        self._ensure_dir("matches")
        with gzip.open(self._matches_path(image), "wb") as f:
            pickle.dump(matches, f)

    def find_matches(self, im1: str, im2: str) -> np.ndarray:
        if self.matches_exists(im1):
            im1_matches = self.load_matches(im1)
            if im2 in im1_matches:
                return np.asarray(im1_matches[im2])
        if self.matches_exists(im2):
            im2_matches = self.load_matches(im2)
            if im1 in im2_matches:
                m = np.asarray(im2_matches[im1])
                if len(m):
                    return m[:, [1, 0]]
        return np.zeros((0, 2), dtype=int)

    # -- tracks ---------------------------------------------------------------
    def load_tracks_manager(
        self, filename: Optional[str] = None
    ) -> pymap.TracksManager:
        return pymap.TracksManager.instanciate_from_file(
            self._fp(filename or "tracks.csv")
        )

    def tracks_exists(self, filename: Optional[str] = None) -> bool:
        return os.path.isfile(self._fp(filename or "tracks.csv"))

    def save_tracks_manager(
        self, tracks_manager: pymap.TracksManager, filename: Optional[str] = None
    ) -> None:
        tracks_manager.write_to_file(self._fp(filename or "tracks.csv"))

    # -- reconstruction -------------------------------------------------------
    def load_reconstruction(
        self, filename: Optional[str] = None
    ) -> List[types.Reconstruction]:
        with open(self._fp(filename or "reconstruction.json")) as f:
            return io.reconstructions_from_json(json.load(f))

    def save_reconstruction(
        self, reconstruction: List[types.Reconstruction],
        filename: Optional[str] = None, minify: bool = False,
    ) -> None:
        with open(self._fp(filename or "reconstruction.json"), "w") as f:
            io.json_dump(io.reconstructions_to_json(reconstruction), f, minify)

    def reconstruction_exists(self, filename: Optional[str] = None) -> bool:
        return os.path.isfile(self._fp(filename or "reconstruction.json"))

    # -- reference ------------------------------------------------------------
    def load_reference_lla(self) -> Dict[str, float]:
        with open(self._fp("reference_lla.json")) as f:
            return json.load(f)

    def save_reference_lla(self, reference: Dict[str, float]) -> None:
        with open(self._fp("reference_lla.json"), "w") as f:
            io.json_dump(reference, f)

    def reference_lla_exists(self) -> bool:
        return os.path.isfile(self._fp("reference_lla.json"))

    def load_reference(self) -> geo.TopocentricConverter:
        lla = self.load_reference_lla()
        return geo.TopocentricConverter(
            lla["latitude"], lla["longitude"], lla["altitude"]
        )

    def reference_exists(self) -> bool:
        return self.reference_lla_exists()

    def init_reference(self, images: Optional[List[str]] = None) -> None:
        """Average GPS of the images as the topocentric origin
        (dataset.py:452-470)."""
        if self.reference_lla_exists():
            return
        lats, lons, alts = [], [], []
        for image in images or self.images():
            if not self.exif_exists(image):
                continue
            d = self.load_exif(image)
            if "gps" in d and "latitude" in d["gps"]:
                lats.append(d["gps"]["latitude"])
                lons.append(d["gps"]["longitude"])
                alts.append(d["gps"].get("altitude", 0.0))
        if lats:
            self.save_reference_lla(
                {
                    "latitude": float(np.median(lats)),
                    "longitude": float(np.median(lons)),
                    "altitude": 0.0,
                }
            )
        else:
            self.save_reference_lla(
                {"latitude": 0.0, "longitude": 0.0, "altitude": 0.0}
            )

    # -- rigs -----------------------------------------------------------------
    def load_rig_cameras(self) -> Dict[str, pymap.RigCamera]:
        path = self._fp("rig_cameras.json")
        if not os.path.isfile(path):
            return {}
        with open(path) as f:
            return io.rig_cameras_from_json(json.load(f))

    def save_rig_cameras(self, rig_cameras: Dict[str, pymap.RigCamera]) -> None:
        with open(self._fp("rig_cameras.json"), "w") as f:
            io.json_dump(io.rig_cameras_to_json(rig_cameras), f)

    def load_rig_assignments(self) -> List[List[Tuple[str, str]]]:
        path = self._fp("rig_assignments.json")
        if not os.path.isfile(path):
            return []
        with open(path) as f:
            return json.load(f)

    def save_rig_assignments(self, assignments) -> None:
        with open(self._fp("rig_assignments.json"), "w") as f:
            io.json_dump(assignments, f)

    # -- GCPs -----------------------------------------------------------------
    def load_ground_control_points(self) -> List[Any]:
        path = self._fp("ground_control_points.json")
        if not os.path.isfile(path):
            return []
        with open(path) as f:
            return io.read_ground_control_points(f)

    # -- reports / profiling ---------------------------------------------------
    def save_report(self, report_str: str, path: str) -> None:
        out = self._fp("reports", path)
        os.makedirs(os.path.dirname(out), exist_ok=True)
        with open(out, "w") as f:
            f.write(report_str)

    def load_report(self, path: str) -> str:
        with open(self._fp("reports", path)) as f:
            return f.read()

    def append_to_profile_log(self, content: str) -> None:
        with open(self._fp("profile.log"), "a") as f:
            f.write(content)

    # -- ply ------------------------------------------------------------------
    def save_ply(
        self, reconstruction: types.Reconstruction,
        tracks_manager: Optional[pymap.TracksManager] = None,
        filename: Optional[str] = None,
        no_cameras: bool = False, no_points: bool = False,
        point_num_views: bool = False,
    ) -> None:
        ply = io.reconstruction_to_ply(
            reconstruction, tracks_manager, no_cameras, no_points, point_num_views
        )
        with open(self._fp(filename or "reconstruction.ply"), "w") as f:
            f.write(ply)

    # -- subsets (rig calibration) --------------------------------------------
    def subset(self, name: str, images_subset: List[str]) -> "DataSet":
        """Symlinked sub-dataset with a subset of images (dataset.py:658):
        the config, the camera models and their overrides (so that the
        subset's `extract_metadata`, which writes through the linked
        camera_models.json, keeps every override), the reference frame,
        and each image with its EXIF and features."""
        subset_path = self._fp(name)
        os.makedirs(os.path.join(subset_path, "images"), exist_ok=True)
        os.makedirs(os.path.join(subset_path, "exif"), exist_ok=True)
        os.makedirs(os.path.join(subset_path, "features"), exist_ok=True)
        os.makedirs(os.path.join(subset_path, "matches"), exist_ok=True)
        for filename in ("config.yaml", "camera_models.json",
                         "camera_models_overrides.json", "reference_lla.json"):
            src = self._fp(filename)
            dst = os.path.join(subset_path, filename)
            if os.path.isfile(src) and not os.path.isfile(dst):
                os.symlink(os.path.abspath(src), dst)
        for image in images_subset:
            targets = [
                (self.image_file(image), os.path.join(subset_path, "images", image)),
                (self._exif_path(image),
                 os.path.join(subset_path, "exif", image + ".exif")),
                (self._feature_path(image),
                 os.path.join(subset_path, "features", image + ".features.npz")),
            ]
            for src, dst in targets:
                if os.path.isfile(src) and not os.path.isfile(dst):
                    os.symlink(os.path.abspath(src), dst)
        return DataSet(subset_path)

    def undistorted_dataset(self) -> "UndistortedDataSet":
        return UndistortedDataSet(self, self._fp("undistorted"))


class UndistortedDataSet:
    """Accessors for undistorted data (dataset.py:716-990)."""

    def __init__(self, base: DataSet, undistorted_data_path: str,
                 io_handler=None) -> None:
        self.base = base
        self.config = base.config
        self.data_path = undistorted_data_path

    def _fp(self, *parts: str) -> str:
        return os.path.join(self.data_path, *parts)

    def _ensure_dir(self, *parts: str) -> str:
        path = self._fp(*parts)
        os.makedirs(path, exist_ok=True)
        return path

    def load_undistorted_shot_ids(self) -> Dict[str, List[str]]:
        with open(self._fp("undistorted_shot_ids.json")) as f:
            return json.load(f)

    def save_undistorted_shot_ids(self, ids: Dict[str, List[str]]) -> None:
        os.makedirs(self.data_path, exist_ok=True)
        with open(self._fp("undistorted_shot_ids.json"), "w") as f:
            io.json_dump(ids, f)

    def _undistorted_image_file(self, image: str) -> str:
        return self._fp("images", image)

    def load_undistorted_image(self, image: str) -> np.ndarray:
        return io.imread(self._undistorted_image_file(image))

    def save_undistorted_image(self, image: str, array: np.ndarray) -> None:
        self._ensure_dir("images")
        io.imwrite(self._undistorted_image_file(image), array)

    def undistorted_image_size(self, image: str) -> Tuple[int, int]:
        return io.image_size(self._undistorted_image_file(image))

    def _grey_png(self, folder: str, image: str) -> Optional[np.ndarray]:
        return _grey_png(self._fp(folder, image + ".png"))

    def load_undistorted_mask(self, image: str) -> Optional[np.ndarray]:
        return self._grey_png("masks", image)

    def undistorted_mask_exists(self, image: str) -> bool:
        return os.path.isfile(self._fp("masks", image + ".png"))

    def save_undistorted_mask(self, image: str, array: np.ndarray) -> None:
        self._ensure_dir("masks")
        io.imwrite(self._fp("masks", image + ".png"), array)

    def load_undistorted_segmentation(self, image: str) -> Optional[np.ndarray]:
        return self._grey_png("segmentations", image)

    def undistorted_segmentation_exists(self, image: str) -> bool:
        return os.path.isfile(self._fp("segmentations", image + ".png"))

    def save_undistorted_segmentation(self, image: str, array: np.ndarray) -> None:
        self._ensure_dir("segmentations")
        io.imwrite(self._fp("segmentations", image + ".png"), array)

    # -- depthmaps ------------------------------------------------------------
    def _depthmap_path(self, image: str, suffix: str) -> str:
        return self._fp("depthmaps", image + "." + suffix)

    def raw_depthmap_exists(self, image: str) -> bool:
        return os.path.isfile(self._depthmap_path(image, "raw.npz"))

    def save_raw_depthmap(self, image, depth, plane, score, nghbr, nghbrs) -> None:
        self._ensure_dir("depthmaps")
        np.savez_compressed(
            self._depthmap_path(image, "raw.npz"),
            depth=depth, plane=plane, score=score, nghbr=nghbr, nghbrs=nghbrs,
        )

    def load_raw_depthmap(self, image: str):
        o = np.load(self._depthmap_path(image, "raw.npz"))
        return o["depth"], o["plane"], o["score"], o["nghbr"], o["nghbrs"]

    def clean_depthmap_exists(self, image: str) -> bool:
        return os.path.isfile(self._depthmap_path(image, "clean.npz"))

    def save_clean_depthmap(self, image, depth, plane, score) -> None:
        self._ensure_dir("depthmaps")
        np.savez_compressed(
            self._depthmap_path(image, "clean.npz"),
            depth=depth, plane=plane, score=score,
        )

    def load_clean_depthmap(self, image: str):
        o = np.load(self._depthmap_path(image, "clean.npz"))
        return o["depth"], o["plane"], o["score"]

    def pruned_depthmap_exists(self, image: str) -> bool:
        return os.path.isfile(self._depthmap_path(image, "pruned.npz"))

    def save_pruned_depthmap(self, image, points, normals, colors, labels) -> None:
        self._ensure_dir("depthmaps")
        np.savez_compressed(
            self._depthmap_path(image, "pruned.npz"),
            points=points, normals=normals, colors=colors, labels=labels,
        )

    def load_pruned_depthmap(self, image: str):
        o = np.load(self._depthmap_path(image, "pruned.npz"))
        return o["points"], o["normals"], o["colors"], o["labels"]

    def point_cloud_file(self, filename: str = "merged.ply") -> str:
        return self._fp("depthmaps", filename)

    def save_point_cloud(self, points, normals, colors, labels,
                         filename: str = "merged.ply") -> None:
        self._ensure_dir("depthmaps")
        with open(self.point_cloud_file(filename), "w") as fp:
            io.point_cloud_to_ply(points, normals, colors, labels, fp)

    # -- undistorted reconstruction/tracks ------------------------------------
    def load_undistorted_reconstruction(self) -> List[types.Reconstruction]:
        with open(self._fp("reconstruction.json")) as f:
            return io.reconstructions_from_json(json.load(f))

    def save_undistorted_reconstruction(
        self, reconstruction: List[types.Reconstruction]
    ) -> None:
        os.makedirs(self.data_path, exist_ok=True)
        with open(self._fp("reconstruction.json"), "w") as f:
            io.json_dump(io.reconstructions_to_json(reconstruction), f, minify=True)

    def load_undistorted_tracks_manager(self) -> pymap.TracksManager:
        return pymap.TracksManager.instanciate_from_file(self._fp("tracks.csv"))

    def save_undistorted_tracks_manager(
        self, tracks_manager: pymap.TracksManager
    ) -> None:
        tracks_manager.write_to_file(self._fp("tracks.csv"))
