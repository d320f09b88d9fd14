"""Split a dataset into geographic submodels (reference
actions/create_submodels.py:16-120): GPS k-means clusters (or the groups of
`image_groups.txt`), grown by their neighbours within `submodel_overlap`
metres, each a symlinked dataset under `submodels/`.  Host only."""

from __future__ import annotations

import json
import logging
import os

import numpy as np

from opensfm_tpu_torch import resolve_device
from opensfm_tpu_torch.large import tools
from opensfm_tpu_torch.large.metadataset import MetaDataSet

logger = logging.getLogger(__name__)


def run_dataset(data, device=None) -> None:
    """Cluster, grow and link the submodels.  The stage runs on the host;
    `device` is resolved as every entry point's (CUDA unless told
    otherwise) and not used."""
    resolve_device(device)
    meta_data = MetaDataSet(data.data_path)
    _create_image_list(data, meta_data)
    if meta_data.image_groups_exists():
        _read_image_groups(meta_data)
    else:
        _cluster_images(meta_data, data.config["submodel_size"])
    _add_cluster_neighbors(meta_data, data.config["submodel_overlap"])
    _save_clusters_geojson(meta_data)

    images, _, _, _ = meta_data.load_clusters()
    clusters = meta_data.load_clusters_with_neighbors()
    image_clusters = [[images[i] for i in cluster] for cluster in clusters]
    meta_data.create_submodels(image_clusters)
    logger.info("Created %d submodels", len(image_clusters))


def _create_image_list(data, meta_data) -> None:
    rows = []
    for image in data.images():
        if not data.exif_exists(image):
            continue
        exif = data.load_exif(image)
        if "gps" in exif and "latitude" in exif["gps"]:
            rows.append((image, exif["gps"]["latitude"], exif["gps"]["longitude"]))
    meta_data.create_image_list(rows)


def _read_image_groups(meta_data) -> None:
    image_cluster = {}
    cluster_images = {}
    for image, group in meta_data.load_image_groups():
        image_cluster[image] = group
        cluster_images.setdefault(group, []).append(image)
    groups = sorted(cluster_images)
    group_index = {g: i for i, g in enumerate(groups)}

    images, positions, labels = [], [], []
    reference = meta_data.data.load_reference()
    for image, lat, lon in meta_data.images_with_gps():
        if image not in image_cluster:
            continue
        x, y, _ = reference.to_topocentric(lat, lon, 0)
        images.append(image)
        positions.append([x, y])
        labels.append(group_index[image_cluster[image]])
    positions = np.array(positions)
    labels = np.array(labels)
    centers = np.array(
        [positions[labels == i].mean(axis=0) for i in range(len(groups))]
    )
    meta_data.save_clusters(images, positions, labels, centers)


def _cluster_images(meta_data, cluster_size: int) -> None:
    """GPS k-means clustering (create_submodels.py:89-108)."""
    images, positions = [], []
    meta_data.data.init_reference()
    reference = meta_data.data.load_reference()
    for image, lat, lon in meta_data.images_with_gps():
        x, y, _ = reference.to_topocentric(lat, lon, 0)
        images.append(image)
        positions.append([x, y])
    positions = np.array(positions, dtype=np.float64)
    nclusters = max(int(np.ceil(len(images) / cluster_size)), 1)
    labels, centers = tools.kmeans(positions, nclusters)
    meta_data.save_clusters(np.asarray(images, dtype=object), positions, labels, centers)


def _add_cluster_neighbors(meta_data, max_distance: float) -> None:
    images, positions, labels, centers = meta_data.load_clusters()
    clusters = tools.add_cluster_neighbors(positions, labels, centers, max_distance)
    image_clusters = [sorted(c) for c in clusters]
    meta_data.save_clusters_with_neighbors(image_clusters)


def _save_clusters_geojson(meta_data) -> None:
    images, positions, labels, centers = meta_data.load_clusters()
    reference = meta_data.data.load_reference()
    features = []
    for image, position, label in zip(images, positions, labels):
        lat, lon, _ = reference.to_lla(position[0], position[1], 0)
        features.append(
            {
                "type": "Feature",
                "geometry": {"type": "Point", "coordinates": [lon, lat]},
                "properties": {"name": str(image), "submodel": int(label)},
            }
        )
    geojson = {"type": "FeatureCollection", "features": features}
    with open(os.path.join(meta_data.data_path, "clusters.geojson"), "w") as f:
        json.dump(geojson, f, indent=4)
