"""Object detector — the nvinfer stage of the DeepStreamTracker counterpart.

The reference runs an external TensorRT engine (ResNet18 TrafficCamNet,
include/video/DeepStreamTracker.h:46-48) inside a GStreamer pipeline. Here
detection is a first-class JAX model: a small anchor-free (CenterNet-style)
convolutional detector whose matmul-heavy conv stack runs on the matrix
units in bfloat16, with a fixed-K top-k decode so the whole forward + decode
stays one static-shape jitted program.

Default classes mirror TrafficCamNet's: car, bicycle, person, roadsign.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np

from video_stab_tpu.models.tracker import TRAFFICCAMNET_LABELS

# Output stride of the backbone (CenterNet convention).
STRIDE = 4


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """Model hyperparameters. Defaults give a ~1M-param detector sized for
    the reference's 640x384 processing resolution
    (DeepStreamTracker.h:49-50)."""

    num_classes: int = len(TRAFFICCAMNET_LABELS)
    widths: tuple = (32, 64, 128, 256)
    head_width: int = 128
    max_detections: int = 100        # maxTrackedObjects default (h:58)
    dtype: Any = jnp.bfloat16        # matrix-unit compute dtype


class ConvBlock(nn.Module):
    features: int
    stride: int = 1
    dtype: Any = jnp.bfloat16

    @nn.compact
    def __call__(self, x):
        x = nn.Conv(self.features, (3, 3), strides=(self.stride, self.stride),
                    padding="SAME", dtype=self.dtype, use_bias=False)(x)
        x = nn.GroupNorm(num_groups=8, dtype=jnp.float32)(x)
        return nn.relu(x)


class CenterNetDetector(nn.Module):
    """Backbone (stride 4) + center heatmap / size / offset heads."""

    cfg: DetectorConfig

    @nn.compact
    def __call__(self, x):
        c = self.cfg
        w1, w2, w3, w4 = c.widths
        x = ConvBlock(w1, stride=2, dtype=c.dtype)(x)
        x = ConvBlock(w1, stride=1, dtype=c.dtype)(x)
        x = ConvBlock(w2, stride=2, dtype=c.dtype)(x)
        x = ConvBlock(w2, stride=1, dtype=c.dtype)(x)
        x = ConvBlock(w3, stride=1, dtype=c.dtype)(x)
        x = ConvBlock(w4, stride=1, dtype=c.dtype)(x)
        feat = ConvBlock(c.head_width, stride=1, dtype=c.dtype)(x)

        heat = nn.Conv(c.num_classes, (1, 1), dtype=jnp.float32,
                       bias_init=nn.initializers.constant(-2.19))(feat)
        size = nn.Conv(2, (1, 1), dtype=jnp.float32)(feat)
        offset = nn.Conv(2, (1, 1), dtype=jnp.float32)(feat)
        return {"heatmap": heat, "size": size, "offset": offset}


def create_detector(cfg: DetectorConfig = DetectorConfig(), seed: int = 0,
                    height: int = 384, width: int = 640):
    """Build model + init params (matches the reference's 640x384 processing
    size, DeepStreamTracker.cpp:87-92)."""
    model = CenterNetDetector(cfg)
    params = model.init(jax.random.PRNGKey(seed),
                        jnp.zeros((1, height, width, 3), jnp.float32))
    return model, params


BUNDLED_WEIGHTS = "centernet_traffic.msgpack"


def save_detector(params, path: str) -> None:
    """Serialize detector weights (flax msgpack)."""
    from flax import serialization
    with open(path, "wb") as f:
        f.write(serialization.to_bytes(params))


def load_detector(path: str, cfg: DetectorConfig = DetectorConfig(),
                  height: int = 384, width: int = 640, seed: int = 0):
    """Load weights saved by save_detector into a fresh template."""
    from flax import serialization
    model, params = create_detector(cfg, seed=seed, height=height,
                                    width=width)
    with open(path, "rb") as f:
        params = serialization.from_bytes(params, f.read())
    return model, params


def bundled_weights_path() -> str:
    import os
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "weights", BUNDLED_WEIGHTS)


def _nms_peaks(heat: jnp.ndarray) -> jnp.ndarray:
    """3x3 max-pool NMS on the class heatmaps (B, Hs, Ws, C)."""
    pooled = nn.max_pool(heat, (3, 3), strides=(1, 1), padding="SAME")
    return jnp.where(heat >= pooled, heat, -jnp.inf)


@functools.partial(jax.jit, static_argnums=(0, 4))
def detect(model, params, frames: jnp.ndarray, score_threshold: float = 0.5,
           max_detections: int = 100):
    """Forward + decode.

    frames: (B, H, W, 3) float32 in [0, 255].
    Returns dict of (B, K) arrays: class_id, score, and (B, K, 4) bboxes
    in x, y, w, h pixels, plus a validity mask (score > threshold —
    confidenceThreshold semantics, DeepStreamTracker.cpp:564-601).
    """
    x = frames / 127.5 - 1.0
    out = model.apply(params, x)
    heat = jax.nn.sigmoid(_nms_peaks(out["heatmap"]))
    b, hs, ws, c = heat.shape

    flat = heat.reshape(b, -1)
    scores, idx = jax.lax.top_k(flat, max_detections)
    cls = idx % c
    pix = idx // c
    gy = (pix // ws).astype(jnp.float32)
    gx = (pix % ws).astype(jnp.float32)

    def gather_map(m, pix_idx):
        return jax.vmap(lambda mm, ii: mm.reshape(-1, mm.shape[-1])[ii])(
            m, pix_idx)

    sizes = gather_map(out["size"], pix)      # (B, K, 2)
    offs = gather_map(out["offset"], pix)     # (B, K, 2)

    cx = (gx + offs[..., 0]) * STRIDE
    cy = (gy + offs[..., 1]) * STRIDE
    bw = jnp.maximum(sizes[..., 0], 0.0) * STRIDE
    bh = jnp.maximum(sizes[..., 1], 0.0) * STRIDE
    bbox = jnp.stack([cx - bw / 2, cy - bh / 2, bw, bh], axis=-1)
    return {
        "class_id": cls.astype(jnp.int32),
        "score": scores,
        "bbox": bbox,
        "valid": scores > score_threshold,
    }


def focal_loss(logits: jnp.ndarray, targets: jnp.ndarray,
               alpha: float = 2.0, beta: float = 4.0) -> jnp.ndarray:
    """CenterNet penalty-reduced focal loss over gaussian-splatted targets."""
    p = jax.nn.sigmoid(logits)
    pos = targets >= 0.999
    pos_loss = -jnp.log(jnp.clip(p, 1e-6)) * (1 - p) ** alpha
    neg_loss = -jnp.log(jnp.clip(1 - p, 1e-6)) * p ** alpha * \
        (1 - targets) ** beta
    n_pos = jnp.maximum(jnp.sum(pos.astype(jnp.float32)), 1.0)
    return (jnp.sum(jnp.where(pos, pos_loss, neg_loss))) / n_pos


def detection_loss(model, params, frames, targets):
    """Total loss: focal on heatmap + masked L1 on size/offset.

    targets: dict with 'heatmap' (B,Hs,Ws,C), 'size' (B,Hs,Ws,2),
    'offset' (B,Hs,Ws,2), 'mask' (B,Hs,Ws,1).
    """
    out = model.apply(params, frames / 127.5 - 1.0)
    l_heat = focal_loss(out["heatmap"], targets["heatmap"])
    m = targets["mask"]
    n = jnp.maximum(jnp.sum(m), 1.0)
    l_size = jnp.sum(jnp.abs(out["size"] - targets["size"]) * m) / n
    l_off = jnp.sum(jnp.abs(out["offset"] - targets["offset"]) * m) / n
    return l_heat + 0.1 * l_size + l_off
