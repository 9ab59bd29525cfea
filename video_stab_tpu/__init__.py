"""video_stab_tpu — a real-time video stabilization & streaming framework.

A ground-up JAX/XLA redesign of the capabilities of OmerMersin/video-stab
(C++/CUDA/OpenCV/GStreamer library for NVIDIA Jetson):

- ``video_stab_tpu.ops``     — pure JAX vision ops (color, resize, warp, features,
  sparse pyramidal Lucas-Kanade flow, Canny, Hough, CLAHE, morphology).
- ``video_stab_tpu.motion``  — motion estimation (vectorized RANSAC similarity,
  closed-form rigid solve) and trajectory filtering (box/gaussian/kalman/
  butterworth, motion-intent classification, drone high-frequency chain) as
  O(window) incremental ring-buffer filters.
- ``video_stab_tpu.core``    — the Stabilizer / RollCorrection / AutoZoomCrop /
  Enhancer component APIs mirroring the reference ``Parameters`` structs
  (reference: include/video/Stabilizer.h:76-175 etc.), built as pure
  ``step(state, frame) -> (state, out)`` functions over explicit state pytrees.
- ``video_stab_tpu.models``  — learned components (DeepStab transform predictor,
  detector + multi-object tracker: the DeepStreamTracker counterpart).
- ``video_stab_tpu.parallel``— device-mesh multi-stream serving (vmap + sharding).
- ``video_stab_tpu.io``      — host runtime: frame sources/sinks, stream graph
  with named channels and hot-switchable routing (the gstd/interpipe analog),
  TCP control channel, REST config endpoint.
- ``video_stab_tpu.utils``   — YAML config (reference schema) + hot reload,
  structured logging/metrics.
"""

__version__ = "0.1.0"

_LAZY = {
    "Stabilizer": "video_stab_tpu.core.stabilizer",
    "StabilizerParams": "video_stab_tpu.core.params",
    "LegacyStabilizer": "video_stab_tpu.core.legacy",
    "LegacyStabilizerParams": "video_stab_tpu.core.params",
    "RollCorrection": "video_stab_tpu.core.rollcorrection",
    "RollCorrectionParams": "video_stab_tpu.core.params",
    "AutoZoomCrop": "video_stab_tpu.core.autozoomcrop",
    "AutoZoomCropParams": "video_stab_tpu.core.params",
    "Enhancer": "video_stab_tpu.core.enhancer",
    "EnhancerParams": "video_stab_tpu.core.params",
    "ModeParams": "video_stab_tpu.core.params",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        mod = importlib.import_module(_LAZY[name])
        return getattr(mod, name)
    raise AttributeError(f"module 'video_stab_tpu' has no attribute {name!r}")

__all__ = [
    "Stabilizer",
    "StabilizerParams",
    "LegacyStabilizer",
    "LegacyStabilizerParams",
    "RollCorrection",
    "RollCorrectionParams",
    "AutoZoomCrop",
    "AutoZoomCropParams",
    "Enhancer",
    "EnhancerParams",
    "ModeParams",
    "__version__",
]
