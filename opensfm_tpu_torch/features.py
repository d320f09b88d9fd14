"""Feature data containers, serialization and the extraction drivers.

Mirrors the reference `opensfm/features.py`: `FeaturesData` and its
versioned npz save/load (features.py:50-278), the root/normalisation
helpers, and the extraction drivers (features.py:281-635) over the port's
HAHOG/SIFT detector (`opensfm_tpu_torch.ops.features`).  The resize
(OpenCV's INTER_AREA as two matrix products) and the grey conversion
(OpenCV's 8-bit fixed-point formula) are the port's own, so nothing here
needs OpenCV.
"""

from __future__ import annotations

import logging
from typing import Any, BinaryIO, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from opensfm_tpu_torch import resolve_device
from opensfm_tpu_torch.geometry.cameras import (  # noqa: F401 (public API)
    denormalized_image_coordinates,
    normalized_image_coordinates,
)

logger = logging.getLogger(__name__)


class SemanticData:
    """Per-feature segmentation/instance labels (features.py:17-47)."""

    def __init__(
        self,
        segmentation: np.ndarray,
        instances: Optional[np.ndarray],
        labels: List[str],
    ) -> None:
        self.segmentation = segmentation
        self.instances = instances
        self.labels = labels

    def __len__(self) -> int:
        return len(self.segmentation)

    def has_instances(self) -> bool:
        return self.instances is not None

    def mask(self, mask: np.ndarray) -> "SemanticData":
        return SemanticData(
            self.segmentation[mask],
            self.instances[mask] if self.instances is not None else None,
            self.labels,
        )


class FeaturesData:
    """Detected features: points[N,>=3] (x, y, scale[, angle]) in normalized
    coordinates, descriptors, colors, optional semantics/depths."""

    FEATURES_VERSION = 3
    FEATURES_HEADER = "OPENSFM_FEATURES_VERSION"

    def __init__(
        self,
        points: np.ndarray,
        descriptors: Optional[np.ndarray],
        colors: np.ndarray,
        semantic: Optional[SemanticData] = None,
        depths: Optional[np.ndarray] = None,
    ) -> None:
        self.points = points
        self.descriptors = descriptors
        self.colors = colors
        self.semantic = semantic
        self.depths = depths

    def __len__(self) -> int:
        return len(self.points)

    def get_segmentation(self) -> Optional[np.ndarray]:
        return self.semantic.segmentation if self.semantic else None

    def has_instances(self) -> bool:
        return bool(self.semantic) and self.semantic.instances is not None

    def mask(self, mask: np.ndarray) -> "FeaturesData":
        return FeaturesData(
            self.points[mask],
            self.descriptors[mask] if self.descriptors is not None else None,
            self.colors[mask] if len(self.colors) else self.colors,
            self.semantic.mask(mask) if self.semantic else None,
            self.depths[mask] if self.depths is not None else None,
        )

    def save(self, fileobject: Union[str, BinaryIO], config: Dict[str, Any]) -> None:
        feature_type = str(config.get("feature_type", "HAHOG")).upper()
        if (
            (feature_type == "AKAZE"
             and config.get("akaze_descriptor") in ["MLDB_UPRIGHT", "MLDB"])
            or (feature_type == "HAHOG" and config.get("hahog_normalize_to_uchar"))
            or (feature_type == "ORB")
        ):
            feature_data_type = np.uint8
        else:
            feature_data_type = np.float32
        if self.descriptors is None:
            raise RuntimeError("No descriptors found, cannot save features data.")
        semantic = self.semantic
        kwargs: Dict[str, Any] = dict(
            points=self.points.astype(np.float32),
            descriptors=self.descriptors.astype(feature_data_type),
            colors=self.colors,
        )
        if semantic:
            kwargs.update(
                segmentations=semantic.segmentation.astype(np.uint8),
                instances=(
                    semantic.instances.astype(np.int16)
                    if semantic.instances is not None
                    else []
                ),
                segmentation_labels=np.array(semantic.labels).astype(str),
            )
        else:
            kwargs.update(segmentations=[], instances=[], segmentation_labels=[])
        kwargs[self.FEATURES_HEADER] = self.FEATURES_VERSION
        np.savez_compressed(fileobject, **kwargs)

    @classmethod
    def from_file(
        cls, fileobject: Union[str, BinaryIO], config: Dict[str, Any]
    ) -> "FeaturesData":
        s = np.load(fileobject, allow_pickle=False)
        version = int(s[cls.FEATURES_HEADER]) if cls.FEATURES_HEADER in s else 0
        feature_type = str(config.get("feature_type", "HAHOG")).upper()
        descriptors = s["descriptors"] if "descriptors" in s else None
        # OpenSfM upcasts uchar descriptors to f32 here for FLANN
        # (features.py from_file); the exact matcher uploads uint8 and
        # upcasts on the device instead, so the quantized dtype is kept.
        points = s["points"].astype(np.float64)
        colors = s["colors"] if "colors" in s else np.zeros((len(points), 3))

        semantic = None
        if version >= 2 and "segmentations" in s and len(s["segmentations"]):
            instances = (
                s["instances"] if "instances" in s and len(s["instances"]) else None
            )
            labels = (
                list(s["segmentation_labels"])
                if "segmentation_labels" in s
                else []
            )
            semantic = SemanticData(s["segmentations"], instances, labels)
        return cls(points, descriptors, colors, semantic)


def root_feature(desc: np.ndarray, l2_normalization: bool = False) -> np.ndarray:
    """RootSIFT mapping: L1-normalize then sqrt (features.py feature_root)."""
    if l2_normalization:
        s2 = np.linalg.norm(desc, axis=1)
        desc = (desc.T / s2).T
    s = np.sum(desc, 1)
    desc = np.sqrt(desc.T / s).T
    return desc


def root_feature_surf(
    desc: np.ndarray, l2_normalization: bool = False, partial: bool = False
) -> np.ndarray:
    """Square-root mapping of SURF-like 64-d descriptors
    (root_feature_surf, features.py:301-321): signed sqrt of (a subset of)
    components, L1-normalized by the full descriptor."""
    if desc.shape[1] != 64:
        return desc
    desc = desc.copy()
    if l2_normalization:
        s2 = np.linalg.norm(desc, axis=1)
        desc = (desc.T / s2).T
    if partial:
        ii = np.array([i for i in range(64) if (i % 4 == 2 or i % 4 == 3)])
    else:
        ii = np.arange(64)
    desc_sub = np.abs(desc[:, ii])
    desc_sub_sign = np.sign(desc[:, ii])
    s_sub = np.sum(np.abs(desc), 1)
    desc_sub = np.sqrt(desc_sub.T / s_sub).T
    desc[:, ii] = desc_sub * desc_sub_sign
    return desc


def normalize_features(
    points: np.ndarray, desc: np.ndarray, colors: np.ndarray,
    width: int, height: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Transform feature coordinates and sizes to normalized units."""
    points[:, :2] = normalized_image_coordinates(points[:, :2], width, height)
    points[:, 2:3] /= max(width, height)
    return points, desc, colors


# ---------------------------------------------------------------------------
# Extraction drivers (features.py:281-635)
# ---------------------------------------------------------------------------


def area_weights(ssize: int, dsize: int) -> np.ndarray:
    """[dsize, ssize] weights of OpenCV's INTER_AREA along one axis
    (computeResizeAreaTab, imgproc/src/resize.cpp): each output pixel
    averages the source interval [d * scale, (d + 1) * scale), partial
    pixels at its ends weighted by their coverage."""
    scale = ssize / dsize
    w = np.zeros((dsize, ssize), dtype=np.float64)
    for dx in range(dsize):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, ssize - fsx1)
        sx1, sx2 = int(np.ceil(fsx1)), int(np.floor(fsx2))
        sx2 = min(sx2, ssize - 1)
        sx1 = min(sx1, sx2)
        if sx1 - fsx1 > 1e-3:
            w[dx, sx1 - 1] = np.float32((sx1 - fsx1) / cell)
        w[dx, sx1:sx2] = np.float32(1.0 / cell)
        if fsx2 - sx2 > 1e-3:
            w[dx, sx2] = np.float32(min(min(fsx2 - sx2, 1.0), cell) / cell)
    return w


def resized_image(image: np.ndarray, max_size: int, device=None) -> np.ndarray:
    """Resize so the largest dimension equals max_size (features.py:281)
    as cv2.resize(..., INTER_AREA) does, on `device` (CUDA unless told
    otherwise): separable coverage weights (`area_weights`), i.e. two
    matrix products, rounded to uint8; at integer ratios OpenCV's box sums
    (resizeAreaFast) bit for bit."""
    from opensfm_tpu_torch.ops.image import resize_area

    h, w = image.shape[:2]
    size = max(w, h)
    if not 0 < max_size < size:
        return image
    return resize_area(image, w * max_size // size, h * max_size // size,
                       device).cpu().numpy()


def rgb_to_grey(image: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(image, COLOR_RGB2GRAY) bit for bit: OpenCV's 15-bit
    fixed-point weights of 0.299, 0.587 and 0.114, rounded (OpenCV 4's
    14-bit weights 4899, 9617, 1868 round a few pixels the other way)."""
    x = np.asarray(image).astype(np.int64)
    return ((9798 * x[..., 0] + 19235 * x[..., 1] + 3735 * x[..., 2]
             + 16384) >> 15).astype(np.uint8)


def extract_features_dog(
    image_gray: np.ndarray, config: Dict[str, Any], features_count: int,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """The HAHOG/SIFT-class detector (ops/features.py) on `device`, with
    the reference's adaptive peak-threshold annealing loop
    (extract_features_sift, features.py:372-406).

    feature_type=HAHOG runs the multi-scale Hessian response with dual
    orientations; feature_type=SIFT runs the classic DoG."""
    from opensfm_tpu_torch.ops.features import extract_dog_features

    feature_type = str(config.get("feature_type", "HAHOG")).upper()
    # Root+uchar on the device (uint8 descriptors come back 4x smaller).
    root_uchar = bool(
        config.get("feature_root")
        and config.get("hahog_normalize_to_uchar")
        and feature_type in ("HAHOG", "SIFT")
    )
    if feature_type == "HAHOG":
        detector = "hessian"
        n_orientations = 2
        edge_threshold = float(config.get("hahog_edge_threshold", 10.0))
        # A det-of-Hessian response threshold (reference default 1e-5).
        peak = max(float(config.get("hahog_peak_threshold", 1e-5)), 1e-7)
        min_peak = 1e-7
    else:
        detector = "dog"
        n_orientations = 1
        edge_threshold = float(config.get("sift_edge_threshold", 10.0))
        peak = float(config.get("sift_peak_threshold", 0.1)) / 10.0
        min_peak = 0.0005
    while True:
        points, desc = extract_dog_features(
            image_gray, peak_threshold=peak, target_features=features_count,
            root_uchar=root_uchar, detector=detector,
            n_orientations=n_orientations, edge_threshold=edge_threshold,
            device=device,
        )
        if len(points) >= features_count or peak <= min_peak:
            break
        peak = max(peak / 3.0, min_peak)
        logger.debug("Reducing peak threshold to %f (%d pts)", peak, len(points))
    return points, desc


def _not_ported(feature_type: str):
    raise NotImplementedError(
        f"feature_type {feature_type} is not ported yet (ROADMAP A8: AKAZE, "
        "and the OpenCV-backed SIFT_CV, ORB and SURF extractors); use HAHOG "
        "or SIFT")


def extract_features(
    image: np.ndarray, config: Dict[str, Any], is_panorama: bool,
    device=None,
) -> FeaturesData:
    """Detect features + colors in normalized coordinates
    (features.py:566-635) on `device` (CUDA unless told otherwise)."""
    extraction_size = (
        config["feature_process_size_panorama"]
        if is_panorama
        else config["feature_process_size"]
    )
    features_count = (
        config["feature_min_frames_panorama"]
        if is_panorama
        else config["feature_min_frames"]
    )

    assert image.ndim in (2, 3)
    image = resized_image(image, extraction_size, device=device)
    if image.ndim == 3:
        image_gray = rgb_to_grey(image)
    else:
        image_gray = image
        image = np.repeat(image_gray[:, :, None], 3, axis=2)

    feature_type = str(config["feature_type"]).upper()
    if feature_type in ("HAHOG", "SIFT"):
        points, desc = extract_features_dog(image_gray, config, features_count,
                                            device=device)
    elif feature_type in ("SIFT_CV", "ORB", "AKAZE", "SURF"):
        _not_ported(feature_type)
    else:
        raise ValueError(
            "Unknown feature type (must be SURF, SIFT, AKAZE, HAHOG or ORB)"
        )

    if len(points) == 0:
        return FeaturesData(
            np.zeros((0, 4)), np.zeros((0, 128), dtype=np.float32),
            np.zeros((0, 3)), None,
        )

    if (
        config.get("feature_root")
        and desc.dtype != np.uint8  # already rooted+quantized on the device
    ):
        desc = np.sqrt(np.maximum(desc, 0))
        # uchar quantization (extract_features_hahog, features.py:526-534).
        if config.get("hahog_normalize_to_uchar"):
            desc = np.clip(desc * 362.0, 0, 255).round()
    xs = np.clip(points[:, 0].round().astype(int), 0, image.shape[1] - 1)
    ys = np.clip(points[:, 1].round().astype(int), 0, image.shape[0] - 1)
    colors = image[ys, xs].astype(np.float64)

    points = np.column_stack(
        [
            normalized_image_coordinates(
                points[:, :2], image.shape[1], image.shape[0]
            ),
            points[:, 2] / max(image.shape[0], image.shape[1]),
            points[:, 3] if points.shape[1] > 3 else np.zeros(len(points)),
        ]
    )
    return FeaturesData(points, desc.astype(np.float32), colors, None)
