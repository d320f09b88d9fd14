"""Bundle adjustment: Levenberg-Marquardt with an explicit Schur complement
over the camera-point structure, robust losses as IRLS weights, and GPS,
camera, point and shot priors as extra residual rows."""

from opensfm_tpu_torch.ba.lm import BAProblem, BAResult, bundle_adjust  # noqa: F401
