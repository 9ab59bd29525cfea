"""Learned components: detector + multi-object tracker (the
DeepStreamTracker counterpart) and the deep-stabilization transform
predictor.

Names load on first use, so that the tracker's parameters (read by the
config loader) do not pull in the model library the detector needs.
"""

_LAZY = {
    "TRAFFICCAMNET_LABELS": "video_stab_tpu.models.tracker",
    "CenterNetDetector": "video_stab_tpu.models.detector",
    "DetectorConfig": "video_stab_tpu.models.detector",
    "create_detector": "video_stab_tpu.models.detector",
    "detect": "video_stab_tpu.models.detector",
    "detection_loss": "video_stab_tpu.models.detector",
    "Detection": "video_stab_tpu.models.tracker",
    "ObjectTracker": "video_stab_tpu.models.tracker",
    "TrackerParams": "video_stab_tpu.models.tracker",
    "DeepStabConfig": "video_stab_tpu.models.deepstab",
    "DeepStabNet": "video_stab_tpu.models.deepstab",
    "create_deepstab": "video_stab_tpu.models.deepstab",
    "predict_transform": "video_stab_tpu.models.deepstab",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(
        f"module 'video_stab_tpu.models' has no attribute {name!r}")


__all__ = sorted(_LAZY)
