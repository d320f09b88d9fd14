"""Video frame import with GPX geotagging.

Port of `opensfm_tpu.video` (reference `opensfm/video.py:12-120`:
video_orientation, import_video_with_gpx).  Decoding stays OpenCV's
`cv2.VideoCapture`, as for the SIFT_CV, ORB and SURF features; the frames
are written by the port's JPEG codec (`io.imwrite`).
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import List, Optional

logger = logging.getLogger(__name__)


def video_orientation(video_file: str) -> int:
    """EXIF-style orientation of a video (video.py:12-33): 1 where cv2 is
    absent or the video carries no rotation the mapping knows."""
    try:
        import cv2
    except ImportError:
        return 1
    cap = cv2.VideoCapture(video_file)
    rotation = cap.get(getattr(cv2, "CAP_PROP_ORIENTATION_META", -1))
    cap.release()
    mapping = {0: 1, 90: 6, 180: 3, 270: 8}
    return mapping.get(int(rotation), 1)


def import_video_with_gpx(
    video_file: str,
    gpx_file: str,
    output_path: str,
    dx: float,
    dt: Optional[float] = None,
    start_time: Optional[str] = None,
    visual: bool = False,
    image_description: Optional[str] = None,
) -> List[str]:
    """Extract frames spaced by gpx distance dx, geotagged from the track
    (video.py:36-120); raises ImportError naming cv2 where it is absent."""
    try:
        import cv2
    except ImportError:
        raise ImportError("reading video needs cv2 (opencv-python), which "
                          "is not installed") from None
    from opensfm_tpu_torch import geotag_from_gpx, io

    points = geotag_from_gpx.get_lat_lon_time(gpx_file)
    if start_time:
        video_start_time = datetime.datetime.strptime(
            start_time, "%Y-%m-%dT%H:%M:%S"
        )
    else:
        try:
            exifdate = datetime.datetime.fromtimestamp(
                os.path.getmtime(video_file)
            )
        except OSError:
            exifdate = points[0][0] if points else datetime.datetime.now()
        video_start_time = exifdate

    os.makedirs(output_path, exist_ok=True)
    cap = cv2.VideoCapture(video_file)
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0

    sampled = geotag_from_gpx.sample_gpx(points, dx, dt)
    image_files = []
    for i, point in enumerate(sampled):
        dt_sec = (point[0] - video_start_time).total_seconds()
        if dt_sec < 0:
            continue
        cap.set(cv2.CAP_PROP_POS_MSEC, dt_sec * 1000.0)
        ret, frame = cap.read()
        if not ret:
            continue
        filepath = os.path.join(output_path, f"{i:06d}.jpg")
        io.imwrite(filepath, frame[..., ::-1])  # BGR -> RGB
        image_files.append(filepath)
    cap.release()
    logger.info("Imported %d frames from %s (%.1f fps)", len(image_files),
                video_file, fps)
    return image_files
