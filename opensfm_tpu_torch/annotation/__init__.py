"""The GCP annotation tool on the port: `run_ba` (alignment of two
reconstructions through their GCPs, the fixed-image bundle and its pose
covariances) and `main` (the web tool), counterparts of
`annotation_gui_gcp/run_ba.py` and `annotation_gui_gcp/main.py`."""
