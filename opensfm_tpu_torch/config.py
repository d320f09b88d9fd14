"""Configuration system.

Parameter surface mirrors the reference `OpenSfMConfig`
(reference: opensfm/config.py:11-392) so existing `config.yaml` files keep
working unchanged.  Internally the config is a plain dict; `load_config`
layers YAML overrides on top of the defaults, exactly like
`load_config_from_fileobject` (reference: opensfm/config.py:400-411).
"""

from __future__ import annotations

import os
from typing import Any, Dict, IO, Optional, Union

import yaml

# Defaults, grouped as in the reference.  Keys are the public API surface.
DEFAULTS: Dict[str, Any] = dict(
    # -- metadata -----------------------------------------------------------
    use_exif_size=True,
    unknown_camera_models_are_different=False,
    default_focal_prior=0.85,
    # -- features -----------------------------------------------------------
    feature_type="HAHOG",
    feature_root=True,
    feature_min_frames=4000,
    feature_min_frames_panorama=16000,
    feature_process_size=2048,
    feature_process_size_panorama=4096,
    feature_use_adaptive_suppression=False,
    features_bake_segmentation=False,
    mem_ceiling=None,
    mem_ratio=None,
    # -- SIFT ---------------------------------------------------------------
    sift_peak_threshold=0.1,
    sift_edge_threshold=10,
    sift_nfeatures=0,
    sift_octave_layers=3,
    sift_sigma=1.6,
    # -- SURF ---------------------------------------------------------------
    surf_hessian_threshold=3000,
    surf_n_octaves=4,
    surf_n_octavelayers=2,
    surf_upright=0,
    # -- AKAZE --------------------------------------------------------------
    akaze_omax=4,
    akaze_dthreshold=0.001,
    akaze_descriptor="MSURF",
    akaze_descriptor_size=0,
    akaze_descriptor_channels=3,
    akaze_kcontrast_percentile=0.7,
    akaze_use_isotropic_diffusion=False,
    # -- HAHOG --------------------------------------------------------------
    hahog_peak_threshold=0.00001,
    hahog_edge_threshold=10,
    hahog_normalize_to_uchar=True,
    # -- general matching ---------------------------------------------------
    lowes_ratio=0.8,
    matcher_type="FLANN",
    symmetric_matching=True,
    # -- FLANN --------------------------------------------------------------
    flann_algorithm="KMEANS",
    flann_branching=8,
    flann_iterations=10,
    flann_tree=8,
    flann_checks=20,
    # -- BoW ----------------------------------------------------------------
    # Reference-scale pretrained vocabulary (reference config.py:120
    # bow_hahog_root_uchar_10000.npz); the 1,024-word one remains shipped
    # for memory-constrained runs.
    bow_file="bow_hahog_root_uchar_10000.npz",
    bow_words_to_match=50,
    bow_num_checks=20,
    bow_matcher_type="FLANN",
    # -- VLAD ---------------------------------------------------------------
    vlad_file="vlad_hahog_root_uchar_64.npz",
    # -- guided matching ----------------------------------------------------
    guided_spanning_trees=5,
    guided_spanning_trees_random=0.5,
    guided_matching_threshold=0.006,
    guided_min_length_initial=3,
    guided_min_length_final=3,
    guided_extend_threshold=0.002,
    guided_extend_image_neighbors=50,
    guided_extend_feature_neighbors=10,
    # -- pair selection -----------------------------------------------------
    matching_gps_distance=150,
    matching_gps_neighbors=0,
    matching_time_neighbors=0,
    matching_order_neighbors=0,
    matching_bow_neighbors=0,
    matching_bow_gps_distance=0,
    matching_bow_gps_neighbors=0,
    matching_bow_other_cameras=False,
    matching_vlad_neighbors=0,
    matching_vlad_gps_distance=0,
    matching_vlad_gps_neighbors=0,
    matching_vlad_other_cameras=False,
    matching_graph_rounds=0,
    matching_use_filters=False,
    matching_use_segmentation=False,
    # -- geometric estimation -----------------------------------------------
    robust_matching_threshold=0.004,
    robust_matching_calib_threshold=0.004,
    robust_matching_min_match=20,
    five_point_algo_threshold=0.004,
    five_point_algo_min_inliers=20,
    five_point_refine_match_iterations=10,
    five_point_refine_rec_iterations=1000,
    five_point_reversal_check=False,
    five_point_reversal_ratio=0.95,
    triangulation_threshold=0.006,
    triangulation_min_ray_angle=1.0,
    triangulation_min_depth=0.001,
    triangulation_type="FULL",
    triangulation_refinement_iterations=10,
    resection_threshold=0.004,
    resection_min_inliers=10,
    # Candidate resections per batched P3P-RANSAC dispatch in the growth
    # loop (TPU extension, SURVEY §7.3: one device program tries a whole
    # round of candidates; 1 = the reference's sequential walk).
    resection_batch_size=8,
    # -- tracks -------------------------------------------------------------
    min_track_length=2,
    use_depth_prior=False,
    depth_std_deviation_m_default=1.0,
    depth_is_radial=False,
    depth_is_inverted=False,
    # -- bundle adjustment --------------------------------------------------
    loss_function="SoftLOneLoss",
    loss_function_threshold=1,
    reprojection_error_sd=0.004,
    exif_focal_sd=0.01,
    aspect_ratio_sd=0.01,
    principal_point_sd=0.01,
    radial_distortion_k1_sd=0.01,
    radial_distortion_k2_sd=0.01,
    radial_distortion_k3_sd=0.01,
    radial_distortion_k4_sd=0.01,
    tangential_distortion_p1_sd=0.01,
    tangential_distortion_p2_sd=0.01,
    gcp_horizontal_sd=0.01,
    gcp_vertical_sd=0.1,
    gcp_global_weight=0.01,
    # TPU-build extension: Cauchy-robust GCP position priors (see ba/problem._add_gcp)
    gcp_robust_prior=True,
    rig_translation_sd=0.1,
    rig_rotation_sd=0.1,
    bundle_outlier_filtering_type="FIXED",
    bundle_outlier_auto_ratio=3.0,
    bundle_outlier_fixed_threshold=0.006,
    optimize_camera_parameters=True,
    bundle_max_iterations=100,
    retriangulation=True,
    retriangulation_ratio=1.2,
    bundle_analytic_derivatives=True,
    bundle_interval=999999,
    bundle_new_points_ratio=1.2,
    local_bundle_radius=3,
    local_bundle_min_common_points=20,
    local_bundle_max_shots=30,
    # Distributed full-map BA over all visible devices (TPU-native
    # replacement for the reference's submodel split, large/tools.py:278):
    # "auto" routes global bundles through the camera-block-sparse CG
    # solver once the map exceeds bundle_distributed_min_shots and more
    # than one device is present; "yes" forces it whenever compatible;
    # "no" always uses the single-device Schur solver.
    bundle_distributed="auto",
    bundle_distributed_min_shots=100,
    bundle_distributed_cg_iters=100,
    # Sharded solver choice: "dense" runs the fused Pallas assembly/cost
    # per shard on the zero-padded [NP, NI] grid (mono single-camera
    # maps at moderate grid sizes — the fastest route when it applies),
    # "schur" assembles the reduced camera system and psums it once per
    # trial (sparse layout, moderate camera counts), "cg" is matrix-free
    # preconditioned CG (scales past a few thousand cameras; ~6 KB psum
    # per iteration), "auto" picks by eligibility and assembly cost.
    bundle_distributed_solver="auto",
    filter_final_point_cloud=False,
    save_partial_reconstructions=False,
    # Merge partial reconstructions that share >=10 triangulated tracks
    # (common-track similarity RANSAC + retriangulate + global bundle).
    # The reference ships the merge machinery but leaves partials
    # separate; `no` restores that behavior.
    merge_partial_reconstructions=True,
    # -- GPS alignment ------------------------------------------------------
    use_altitude_tag=True,
    align_method="auto",
    align_orientation_prior="horizontal",
    bundle_use_gps=True,
    bundle_use_gcp=True,
    bundle_compensate_gps_bias=False,
    # -- rigs ---------------------------------------------------------------
    rig_calibration_subset_size=15,
    rig_calibration_completeness=0.85,
    rig_calibration_max_rounds=10,
    # -- undistortion -------------------------------------------------------
    undistorted_image_format="jpg",
    undistorted_image_max_size=100000,
    # -- dense depth --------------------------------------------------------
    depthmap_method="PATCH_MATCH_SAMPLE",
    depthmap_resolution=640,
    depthmap_num_neighbors=10,
    depthmap_num_matching_views=6,
    depthmap_min_depth=0,
    depthmap_max_depth=0,
    depthmap_patchmatch_iterations=3,
    depthmap_patch_size=7,
    depthmap_min_patch_sd=1.0,
    depthmap_min_correlation_score=0.1,
    depthmap_same_depth_threshold=0.01,
    depthmap_min_consistent_views=3,
    depthmap_save_debug_files=False,
    # -- threading (host-side orchestration only) ---------------------------
    processes=1,
    read_processes=4,
    # -- submodels ----------------------------------------------------------
    submodel_size=80,
    submodel_overlap=30.0,
    submodels_relpath="submodels",
    submodel_relpath_template="submodels/submodel_%04d",
    submodel_images_relpath_template="submodels/submodel_%04d/images",
    # -- TPU-specific knobs (no reference equivalent) -----------------------
    # dtype used for device-side geometry/BA math ("float32" or "float64").
    tpu_compute_dtype="float64",
    # number of batched RANSAC hypotheses evaluated per problem
    ransac_batch_hypotheses=1024,
)


def default_config() -> Dict[str, Any]:
    """A fresh copy of the default configuration."""
    return dict(DEFAULTS)


def load_config_from_fileobject(
    f: Union[IO[bytes], IO[str], bytes, str],
) -> Dict[str, Any]:
    """Defaults overridden by a YAML config file object."""
    config = default_config()
    overrides = yaml.safe_load(f)
    if overrides:
        config.update(overrides)
    return config


def load_config(filepath: Optional[str]) -> Dict[str, Any]:
    """Defaults overridden by a YAML config file path (if it exists)."""
    if filepath and os.path.isfile(filepath):
        with open(filepath) as f:
            return load_config_from_fileobject(f)
    return default_config()
