"""Fine-tune the bundled detector with photo-background + hard-scene
mixing, report PR curves, and (only if the floors hold in every domain)
replace the bundled weights.

Usage: python tools/finetune_photo.py [steps] [photo_prob] [hard_prob] [lr]
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

import jax
from video_stab_tpu.utils.cache import enable_compilation_cache
enable_compilation_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
import cv2
cv2.setNumThreads(0)

from video_stab_tpu.models.detector import bundled_weights_path
from video_stab_tpu.models.train import pr_curve, train_detector

steps = int(sys.argv[1]) if len(sys.argv) > 1 else 600
photo_prob = float(sys.argv[2]) if len(sys.argv) > 2 else 0.5
hard_prob = float(sys.argv[3]) if len(sys.argv) > 3 else 0.3
lr = float(sys.argv[4]) if len(sys.argv) > 4 else 2e-4
out_path = "video_stab_tpu/models/weights/centernet_traffic_ft.msgpack"
model, params, losses = train_detector(
    n_steps=steps, batch=8, height=192, width=320, use_scenes=True,
    photo_prob=photo_prob, hard_prob=hard_prob,
    init_weights=bundled_weights_path(),
    lr=lr, save_path=out_path, log_every=25, seed=123)
print("final losses:", [round(l, 3) for l in losses[-5:]], flush=True)
for bg, hard in (("rendered", False), ("photo", False), ("photo", True)):
    rows = pr_curve(model, params, n_scenes=24, seed=4242,
                    background=bg, hard=hard)
    print(f"--- {bg} hard={hard}", flush=True)
    for r in rows:
        print(f"  t={r['threshold']:.2f} R={r['recall']:.3f} "
              f"P={r['precision']:.3f} tp={r['tp']} fp={r['fp']} "
              f"fn={r['fn']}", flush=True)
