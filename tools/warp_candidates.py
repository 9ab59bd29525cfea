"""Time emit-warp candidates inside the fused chain step on the GPU.

    python tools/warp_candidates.py [--frames 64] [--sizes 1080p,4k]
        [--candidates gather,tiled,none] [--reps 3]

Each candidate replaces ``warp_affine_fast`` in the chain and the
stabilizer before tracing, and the whole fused step (enhance + roll +
stabilize, smoothing_radius=15) runs as one ``lax.scan`` over the frames,
timed to ``block_until_ready``. Candidates run in turns (a, b, none, a, b,
none, ...) so they share the card's state, and each turn's difference to
``none`` is reported as that candidate's warp time. Candidates:

- ``gather``: ops/warp.warp_affine_fast, the gather warp on the u8 frame;
- ``tiled``: ops/warp.warp_affine_tiled (dynamic slices over 8x128 tiles)
  at the fused emit's envelope, 13 deg and 128 px;
- ``none``: no resample at all, the rest of the step alone.

Prints one line per measurement and writes the table to
chiprun_out/warp_candidates.json.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from video_stab_tpu.core import chain as chain_mod  # noqa: E402
from video_stab_tpu.core import stabilizer as stab_mod  # noqa: E402
from video_stab_tpu.core.chain import (ChainParams, chain_init_step,  # noqa: E402
                                       chain_state_init, chain_step_fn)
from video_stab_tpu.core.params import (EnhancerParams, ModeParams,  # noqa: E402
                                        RollCorrectionParams,
                                        StabilizerParams)
from video_stab_tpu.ops import warp as W  # noqa: E402
from video_stab_tpu.utils.cache import enable_compilation_cache  # noqa: E402


def cand_tiled(img, m, out_h=None, out_w=None, border_mode=0,
               border_value=0.0):
    # The envelope the fused emit budgeted for: warp_envelope_deg 3 plus
    # the roll band 10, with 128 px of shift.
    out = W.warp_affine_tiled(W._to_u8(img).astype(jnp.float32), m, out_h,
                              out_w, border_mode, border_value,
                              max_angle_deg=13.0, max_shift=128)
    return jnp.clip(jnp.round(out), 0, 255)


def cand_none(img, m, out_h=None, out_w=None, **_):
    return W._to_u8(img).astype(jnp.float32)


# The gather candidate is the emit warp itself (ops/warp.warp_affine_fast).
CANDIDATES = {"gather": W.warp_affine_fast, "tiled": cand_tiled,
              "none": cand_none}
SIZES = {"1080p": (1080, 1920), "4k": (2160, 3840)}


def chain_params() -> ChainParams:
    return ChainParams(
        mode=ModeParams(enhancer_enabled=True, roll_correction_enabled=True,
                        stabilizer_enabled=True),
        enhancer=EnhancerParams(brightness=5.0, contrast=1.1, gamma=0.9),
        roll=RollCorrectionParams(),
        stabilizer=StabilizerParams(smoothing_radius=15))


def build(params, cand):
    """Trace the scanned chain step with ``cand`` as the warp."""
    chain_mod.warp_affine_fast = CANDIDATES[cand]
    stab_mod.warp_affine_fast = CANDIDATES[cand]

    def run(state, frames):
        return jax.lax.scan(lambda s, f: chain_step_fn(params, s, f),
                            state, frames)

    return jax.jit(run)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--sizes", default="1080p,4k")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--candidates", default="gather,tiled,none")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    enable_compilation_cache()
    dev = chip_smoke.require_gpu()
    card = chip_smoke.card_line()
    print("card:", card, "| device_kind:", dev.device_kind, flush=True)
    params = chain_params()
    rows = []
    for size in args.sizes.split(","):
        h, w = SIZES[size]
        clip = chip_smoke.make_clip(args.seed, args.frames + 1, h, w)
        frames = jax.device_put(clip[1:], dev)
        state0 = jax.device_put(chain_state_init(params, h, w), dev)
        state0 = chain_init_step(params, state0, clip[0])
        cands = args.candidates.split(",")
        fns = {}
        for c in cands:
            t0 = time.perf_counter()
            fns[c] = build(params, c).lower(state0, frames).compile()
            jax.block_until_ready(fns[c](state0, frames))
            print(f"{size} {c}: compile+first run "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
        times = {c: [] for c in cands}
        for _ in range(args.reps):
            for c in cands:
                t0 = time.perf_counter()
                jax.block_until_ready(fns[c](state0, frames))
                times[c].append((time.perf_counter() - t0) / args.frames)
        for c in cands:
            ms = [t * 1e3 for t in times[c]]
            row = {"size": size, "candidate": c, "frames": args.frames,
                   "ms_per_frame_median": statistics.median(ms),
                   "ms_per_frame_all": ms}
            if "none" in times and c != "none":
                # Paired by turn: the warp's own ms/frame in each turn.
                d = [(a - b) * 1e3 for a, b in zip(times[c], times["none"])]
                row.update(warp_ms_median=statistics.median(d),
                           warp_ms_min=min(d), warp_ms_max=max(d))
            rows.append(row)
            print(json.dumps(row), flush=True)
    out = {"card": card, "device_kind": dev.device_kind, "rows": rows}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "warp_candidates.json"),
              "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
