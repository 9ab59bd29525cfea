"""YAML configuration — the reference's config.yaml schema, typed.

Parses the exact OpenCV-FileStorage-dialect YAML the reference apps consume
(examples/config.yaml: %YAML:1.0 directive, sections video_source / mode /
camera / enhancer / roll_correction / stabilizer / deepstream_tracker;
parser counterpart: readConfig, examples/vsg.cpp:920-1155), including the
reference's quirks: camelCase stragglers (fadeAlpha/fadeDuration), enum-int
fields (feature_detector_type, jitter_frequency), roi as 4 scalar keys, and
unknown keys ignored.

Hot reload mirrors the apps' mtime polling (vsg.cpp:1346-1415): a watcher
thread stats the file and invokes a callback with the freshly parsed
AppConfig when it changes.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Any, Callable, Optional

from video_stab_tpu.core.params import (
    AutoZoomCropParams,
    EnhancerParams,
    ModeParams,
    RollCorrectionParams,
    StabilizerParams,
)
from video_stab_tpu.models.tracker import TrackerParams


@dataclasses.dataclass(frozen=True)
class CameraParams:
    """vs::CamCap::Parameters (include/video/CamCap.h:24-35)."""

    source: str = "0"
    threaded_queue_mode: bool = True
    colorspace: str = ""
    logging: bool = False
    time_delay: int = 0
    thread_timeout: int = 500    # ms
    queue_size: int = 5


@dataclasses.dataclass
class AppConfig:
    video_source: str = "0"
    output_source: str = ""
    mode: ModeParams = dataclasses.field(default_factory=ModeParams)
    camera: CameraParams = dataclasses.field(default_factory=CameraParams)
    enhancer: EnhancerParams = dataclasses.field(default_factory=EnhancerParams)
    roll_correction: RollCorrectionParams = dataclasses.field(
        default_factory=RollCorrectionParams)
    stabilizer: StabilizerParams = dataclasses.field(
        default_factory=StabilizerParams)
    auto_zoom_crop: AutoZoomCropParams = dataclasses.field(
        default_factory=AutoZoomCropParams)
    tracker: TrackerParams = dataclasses.field(default_factory=TrackerParams)
    # vstab extension (no reference counterpart): single-resample roll —
    # compose the roll rotation into the stabilizer's emit warp instead
    # of rotating the full frame separately (core/chain.py fuse_roll).
    roll_fusion: bool = True


_FEATURE_DETECTORS = {0: "gftt", 1: "orb", 2: "fast", 3: "brisk"}
_JITTER_FREQS = {0: "low", 1: "medium", 2: "high", 3: "adaptive"}

# Reference-key -> our-field renames inside the stabilizer section.
_STAB_RENAMES = {
    "fadeAlpha": "fade_alpha",
    "fadeDuration": "fade_duration",
}
# Known reference spellings/aliases.
_SMOOTHING_ALIASES = {"gausian": "gaussian"}


def _to_bool(v: Any) -> bool:
    if isinstance(v, str):
        return v.strip().lower() in ("1", "true", "yes", "on")
    return bool(v)


def _coerce(cls, section: dict, extra_map: Optional[dict] = None):
    """Fill a frozen dataclass from a raw YAML section, coercing types and
    ignoring unknown keys (the reference's FileStorage reads are per-key and
    tolerate absences, vsg.cpp:920-1155)."""
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for key, val in (section or {}).items():
        key = (extra_map or {}).get(key, key)
        if key not in fields:
            continue
        f = fields[key]
        try:
            if f.type in ("bool", bool):
                kwargs[key] = _to_bool(val)
            elif f.type in ("int", int):
                kwargs[key] = int(float(val))
            elif f.type in ("float", float):
                kwargs[key] = float(val)
            elif f.type in ("str", str):
                kwargs[key] = str(val)
            else:
                kwargs[key] = val
        except (TypeError, ValueError):
            continue
    return cls(**kwargs)


def parse_config_text(text: str) -> AppConfig:
    # The OpenCV FileStorage dialect starts with "%YAML:1.0" which PyYAML
    # rejects as a directive; strip it (and a possible "---").
    import yaml

    lines = [ln for ln in text.splitlines()
             if not ln.strip().startswith("%YAML")]
    raw = yaml.safe_load("\n".join(lines)) or {}

    stab_raw = dict(raw.get("stabilizer") or {})
    # ROI comes as 4 scalars (config.yaml roi_x..roi_height).
    roi = (int(stab_raw.pop("roi_x", 0)), int(stab_raw.pop("roi_y", 0)),
           int(stab_raw.pop("roi_width", 0)),
           int(stab_raw.pop("roi_height", 0)))
    # Enum-int fields.
    if "feature_detector_type" in stab_raw:
        stab_raw["feature_detector"] = _FEATURE_DETECTORS.get(
            int(stab_raw.pop("feature_detector_type")), "gftt")
    if "jitter_frequency" in stab_raw and \
            isinstance(stab_raw["jitter_frequency"], (int, float)):
        stab_raw["jitter_frequency"] = _JITTER_FREQS.get(
            int(stab_raw["jitter_frequency"]), "adaptive")
    if "smoothing_method" in stab_raw:
        m = str(stab_raw["smoothing_method"]).lower()
        stab_raw["smoothing_method"] = _SMOOTHING_ALIASES.get(m, m)

    stab = _coerce(StabilizerParams, stab_raw, _STAB_RENAMES)
    if any(roi):
        stab = dataclasses.replace(stab, roi=roi)

    tracker_raw = dict(raw.get("deepstream_tracker") or {})

    cfg = AppConfig(
        video_source=str(raw.get("video_source", "0")),
        output_source=str(raw.get("output_source", "") or
                          raw.get("output_url", "")),
        mode=_coerce(ModeParams, raw.get("mode")),
        camera=_coerce(CameraParams, raw.get("camera")),
        enhancer=_coerce(EnhancerParams, raw.get("enhancer")),
        roll_correction=_coerce(RollCorrectionParams,
                                raw.get("roll_correction")),
        stabilizer=stab,
        auto_zoom_crop=_coerce(AutoZoomCropParams, raw.get("auto_zoom_crop")),
        tracker=_coerce(TrackerParams, tracker_raw),
        roll_fusion=_to_bool(raw.get("roll_fusion", True)),
    )
    return cfg


def load_config(path: str) -> AppConfig:
    with open(path) as f:
        return parse_config_text(f.read())


def save_config(cfg: AppConfig, path: str) -> None:
    """Write an AppConfig back out in the reference's schema (with the
    %YAML:1.0 header so reference C++ apps can read it too)."""
    def section(params, skip=()):
        d = {}
        for f in dataclasses.fields(params):
            if f.name in skip:
                continue
            v = getattr(params, f.name)
            if isinstance(v, tuple):
                continue
            d[f.name] = v
        return d

    stab = section(cfg.stabilizer, skip=("roi",))
    stab.update({
        "roi_x": cfg.stabilizer.roi[0], "roi_y": cfg.stabilizer.roi[1],
        "roi_width": cfg.stabilizer.roi[2],
        "roi_height": cfg.stabilizer.roi[3],
    })
    doc = {
        "video_source": cfg.video_source,
        "output_source": cfg.output_source,
        "mode": section(cfg.mode),
        "camera": section(cfg.camera),
        "enhancer": section(cfg.enhancer),
        "roll_correction": section(cfg.roll_correction),
        "stabilizer": stab,
        "auto_zoom_crop": section(cfg.auto_zoom_crop),
        "deepstream_tracker": section(cfg.tracker, skip=("labels",)),
        "roll_fusion": cfg.roll_fusion,
    }
    import yaml

    with open(path, "w") as f:
        f.write("%YAML:1.0\n")
        yaml.safe_dump(doc, f, sort_keys=False)


class ConfigWatcher:
    """mtime-polling hot reload (vsg.cpp:1346-1415 semantics)."""

    def __init__(self, path: str, on_change: Callable[[AppConfig], None],
                 poll_interval: float = 1.0):
        self.path = path
        self.on_change = on_change
        self.poll_interval = poll_interval
        self._mtime = self._stat()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _stat(self) -> float:
        try:
            return os.stat(self.path).st_mtime
        except OSError:
            return 0.0

    def check_once(self) -> bool:
        """Poll once; fire the callback if the file changed. Returns True on
        a reload."""
        m = self._stat()
        if m != self._mtime and m != 0.0:
            self._mtime = m
            try:
                self.on_change(load_config(self.path))
                return True
            except Exception:
                return False
        return False

    def _loop(self):
        while not self._stop.is_set():
            self.check_once()
            self._stop.wait(self.poll_interval)

    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2.0)
