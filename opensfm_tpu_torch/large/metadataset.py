"""Meta-dataset: the submodels directory layout.

Port of `opensfm_tpu.large.metadataset` (reference
`opensfm/large/metadataset.py:15-113`): the same files
(`image_list_with_gps.tsv`, `clusters.npz`, `clusters_with_neighbors.npz`,
`image_groups.txt`) and the same symlinked submodel directories.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Tuple

import numpy as np

from opensfm_tpu_torch.dataset import DataSet


class MetaDataSet:
    def __init__(self, data_path: str) -> None:
        self.data_path = data_path
        self.data = DataSet(data_path)
        config = self.data.config
        self._submodels_dir_path = os.path.join(
            data_path, config["submodels_relpath"]
        )
        self._submodel_dir_template = config["submodel_relpath_template"]
        self._submodel_images_template = config["submodel_images_relpath_template"]

    # -- paths ---------------------------------------------------------------
    def _fp(self, *parts) -> str:
        return os.path.join(self.data_path, *parts)

    def image_groups_exists(self) -> bool:
        return os.path.isfile(self._fp("image_groups.txt"))

    def load_image_groups(self) -> Iterator[Tuple[str, str]]:
        with open(self._fp("image_groups.txt")) as f:
            for line in f:
                image, group = line.split()
                yield image, group

    def image_list_path(self) -> str:
        return self._fp("image_list_with_gps.tsv")

    def create_image_list(self, rows: List[Tuple[str, float, float]]) -> None:
        with open(self.image_list_path(), "w") as f:
            for image, lat, lon in rows:
                f.write(f"{image}\t{lat}\t{lon}\n")

    def images_with_gps(self) -> Iterator[Tuple[str, float, float]]:
        with open(self.image_list_path()) as f:
            for line in f:
                image, lat, lon = line.strip().split("\t")
                yield image, float(lat), float(lon)

    def save_clusters(self, images, positions, labels, centers) -> None:
        np.savez_compressed(
            self._fp("clusters.npz"),
            images=np.asarray(images, dtype=object),
            positions=positions, labels=labels, centers=centers,
        )

    def load_clusters(self):
        c = np.load(self._fp("clusters.npz"), allow_pickle=True)
        return c["images"], c["positions"], c["labels"], c["centers"]

    def save_clusters_with_neighbors(self, clusters) -> None:
        np.savez_compressed(
            self._fp("clusters_with_neighbors.npz"),
            clusters=np.asarray(clusters, dtype=object),
        )

    def load_clusters_with_neighbors(self):
        return np.load(
            self._fp("clusters_with_neighbors.npz"), allow_pickle=True
        )["clusters"]

    # -- submodels -----------------------------------------------------------
    def get_submodel_paths(self) -> List[str]:
        if not os.path.isdir(self._submodels_dir_path):
            return []
        out = []
        for name in sorted(os.listdir(self._submodels_dir_path)):
            path = os.path.join(self._submodels_dir_path, name)
            if os.path.isdir(path):
                out.append(path)
        return out

    def create_submodels(self, clusters) -> None:
        """Symlinked per-cluster dataset dirs (metadataset.py:77-113)."""
        data_path = os.path.abspath(self.data_path)
        for i, cluster in enumerate(clusters):
            submodel_path = self._fp(self._submodel_dir_template % i)
            submodel_images_path = self._fp(self._submodel_images_template % i)
            os.makedirs(submodel_path, exist_ok=True)
            os.makedirs(submodel_images_path, exist_ok=True)

            # Link images.
            for image in cluster:
                src = self.data.image_file(image)
                dst = os.path.join(submodel_images_path, image)
                if not os.path.islink(dst):
                    os.symlink(src, dst)

            # Link common config/files.
            for filename in (
                "config.yaml", "camera_models.json", "reference_lla.json",
                "exif", "features", "matches",
            ):
                src = os.path.join(data_path, filename)
                dst = os.path.join(submodel_path, filename)
                if os.path.exists(src) and not os.path.islink(dst):
                    os.symlink(src, dst)
