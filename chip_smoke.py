"""Smoke test of the stabilization system on one NVIDIA GPU.

    python chip_smoke.py [--seed N]          # one card, every phase
    python chip_smoke.py --four-cards        # the stream-sharded mesh only

Drives the main path through the entry points a user calls: the emit warp
against its plain gather reference, the fused chain (enhance -> roll ->
stabilize) against the same chain on the CPU backend, the served app,
the 4K chain, batched streams with a mid-run reset, and the offline clip
path. Content is made from ``--seed`` with numpy and scipy only, so the
same seed gives the same frames on every machine.

Each phase prints its name, seconds, frames and ms/frame. The card's name
and power limit come from nvidia-smi. The last line of standard output is
one JSON object, ``{"ok": true, "device": {...}}``, printed only when every
phase passed on a GPU. Without a GPU backend (JAX_PLATFORMS=cpu, no card,
or a CUDA plugin that failed to start) the script exits non-zero before
any phase.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

# The CPU reference of phases 1-2 needs the CPU backend beside the GPU's.
_platforms = os.environ.get("JAX_PLATFORMS", "")
if _platforms and "cpu" not in _platforms.split(",") \
        and any(p in ("cuda", "gpu") for p in _platforms.split(",")):
    os.environ["JAX_PLATFORMS"] = _platforms + ",cpu"


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"
    return out.strip().splitlines()[0] if out.strip() else "nvidia-smi: empty"


def require_gpu():
    """The first GPU device; raises RuntimeError on any other backend, even
    when JAX_PLATFORMS=cpu asked for it: a CPU run must never report ok."""
    from video_stab_tpu.utils.device import require_gpu as _require

    return _require(allow_requested_cpu=False)


def make_clip(seed: int, n: int, h: int, w: int) -> np.ndarray:
    """(n, h, w, 3) uint8 frames of a smoothed random world with a horizon
    and two roof lines (so the roll estimator finds lines), seen through a
    window with translation jitter, a slow pan, rotation and zoom."""
    from scipy import ndimage

    rng = np.random.default_rng(seed)
    margin = max(h, w) // 10
    wh, ww = h + 2 * margin, w + 2 * margin
    world = ndimage.gaussian_filter(
        rng.standard_normal((wh, ww)).astype(np.float32), 2.0 * w / 1920)
    world = 100.0 + world * (40.0 / max(float(world.std()), 1e-6))
    world[: int(wh * 0.42)] += 70.0                    # sky above the horizon
    for frac in (0.62, 0.78):                          # roof lines
        world[int(wh * frac): int(wh * frac) + max(4, h // 100)] -= 60.0
    world = np.clip(world, 0.0, 255.0)
    gains = np.float32([0.92, 1.0, 1.06])
    frames = np.empty((n, h, w, 3), np.uint8)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    for i in range(n):
        ang = np.radians(1.5 * np.sin(i / 9.0) + rng.normal(0.0, 0.3))
        zoom = 1.0 + 0.01 * np.sin(i / 13.0)
        ty, tx = rng.normal(0.0, 3.0 * h / 1080, 2)
        tx += 0.5 * i * w / 1920                       # slow pan
        c, s = np.cos(ang) / zoom, np.sin(ang) / zoom
        mat = np.array([[c, -s], [s, c]])
        # world coordinate = mat @ (out - centre) + centre + margin + t
        offset = (np.array([cy + margin + ty, cx + margin + tx])
                  - mat @ np.array([cy, cx]))
        g = ndimage.affine_transform(world, mat, offset=offset,
                                     output_shape=(h, w), order=1,
                                     mode="nearest")
        frames[i] = np.clip(np.rint(g[:, :, None] * gains), 0, 255)
    return frames


# ---------------------------------------------------------------------------
# Shared set-up
# ---------------------------------------------------------------------------

WARP_MAX_ABS = 1           # counts: .5 ties may round either way under FMA
WARP_MIN_EQUAL = 0.999     # share of pixels that must be identical
# Card vs CPU: XLA:GPU and XLA:CPU contract and divide differently, so the
# source coordinates differ by an ulp; under the composed 13 deg roll they
# carry terms of ~10^3 px, and a near-.5 bilinear value then rounds the
# other way on ~0.15% of 1080p pixels (PERF.md, bring-up findings).
WARP_MIN_EQUAL_CROSS = 0.995
CHAIN_MAX_DXY = 0.1        # px (analysis resolution)
CHAIN_MAX_DA = 1e-3        # rad
CHAIN_MAX_MEAN_ABS = 0.5   # counts, per emitted frame
HOMOG_MAX_REL_FRO = 1e-3

HD = (1080, 1920)
UHD = (2160, 3840)


class Ctx:
    """Devices and content shared by the phases (made once, on demand)."""

    def __init__(self, seed: int):
        import jax

        self.seed = seed
        self.gpu = jax.devices()[0]
        self.cpu = jax.devices("cpu")[0]
        self._clips = {}

    def clip(self, n: int, h: int, w: int) -> np.ndarray:
        """The first n frames of the clip at (h, w): 240 frames at HD and
        48 at UHD are made at the first request, the most any phase uses."""
        have = self._clips.get((h, w))
        if have is None or have.shape[0] < n:
            total = max(n, {HD: 240, UHD: 48}.get((h, w), n))
            have = make_clip(self.seed + h, total, h, w)
            self._clips[(h, w)] = have
        return have[:n]


def chain_components(**stab):
    from video_stab_tpu.core.params import (EnhancerParams, ModeParams,
                                            RollCorrectionParams,
                                            StabilizerParams)

    return (ModeParams(enhancer_enabled=True, roll_correction_enabled=True,
                       stabilizer_enabled=True),
            EnhancerParams(brightness=5.0, contrast=1.1, gamma=0.9),
            RollCorrectionParams(),
            StabilizerParams(smoothing_radius=15, **stab))


def compare_u8(a, b) -> tuple[float, float]:
    """(max |a-b|, share of identical pixels)."""
    d = np.abs(np.asarray(a, np.int64) - np.asarray(b, np.int64))
    return float(d.max()), float(np.mean(d == 0))


def warp_tolerance_error(name, a, b, min_equal=WARP_MIN_EQUAL):
    """None within tolerance, else the reason; and (max|d|, identical)."""
    dmax, same = compare_u8(a, b)
    if dmax > WARP_MAX_ABS or same < min_equal:
        return f"{name}: max|d|={dmax} identical={same:.5f}", (dmax, same)
    return None, (dmax, same)


def check_warp_tolerance(name, a, b):
    err, d = warp_tolerance_error(name, a, b)
    if err:
        raise AssertionError(err)
    return d


# ---------------------------------------------------------------------------
# Phases: each returns (frames, detail string)
# ---------------------------------------------------------------------------

def phase_warp(ctx):
    """The chosen emit warp against the u8-quantised gather reference, on
    the card and on the CPU, at 1080p and 2160p x3."""
    import jax
    import jax.numpy as jnp

    from video_stab_tpu.ops.warp import (rotation_matrix_2d,
                                         similarity_matrix, warp_affine,
                                         warp_affine_fast, warp_perspective,
                                         warp_perspective_fast)

    def ref_affine(img, m):
        out = warp_affine(img.astype(jnp.float32), m)
        return jnp.clip(jnp.round(out), 0, 255).astype(jnp.uint8)

    def ref_persp(img, hm):
        out = warp_perspective(img.astype(jnp.float32), hm)
        return jnp.clip(jnp.round(out), 0, 255).astype(jnp.uint8)

    def fast(fn):
        return jax.jit(lambda img, m: fn(img, m).astype(jnp.uint8))

    fast_affine, fast_persp = fast(warp_affine_fast), fast(
        warp_perspective_fast)
    ref_affine, ref_persp = jax.jit(ref_affine), jax.jit(ref_persp)
    details, errors, n = [], [], 0
    for h, w in (HD, UHD):
        img = ctx.clip(1, h, w)[0]
        corr = similarity_matrix(12.3 * w / 1920, -7.8 * h / 1080,
                                 np.radians(0.8))
        # Correction composed with the fused roll at the widest budget the
        # chain allowed: warp_envelope_deg (3) + aux_rotation_deg (10).
        roll = rotation_matrix_2d(w / 2.0, h / 2.0, 10.0)
        row3 = np.float32([[0, 0, 1]])
        composed = (np.concatenate([similarity_matrix(
            9.0, -4.0, np.radians(3.0)), row3])
            @ np.concatenate([roll, row3]))[:2].astype(np.float32)
        hm = np.float32([[1.004, -0.012, 6.5], [0.011, 0.998, -3.25],
                         [2e-5 * 1920 / w, -1.5e-5 * 1080 / h, 1.0]])
        cases = (("affine", fast_affine, ref_affine, np.asarray(corr)),
                 ("affine+roll", fast_affine, ref_affine, composed),
                 ("projective", fast_persp, ref_persp, hm))
        for name, f, ref, m in cases:
            got = np.asarray(f(jax.device_put(img, ctx.gpu),
                               jax.device_put(m, ctx.gpu)))
            on_gpu = np.asarray(ref(jax.device_put(img, ctx.gpu),
                                    jax.device_put(m, ctx.gpu)))
            on_cpu = np.asarray(ref(jax.device_put(img, ctx.cpu),
                                    jax.device_put(m, ctx.cpu)))
            label = f"{name}@{h}p"
            e1, d1 = warp_tolerance_error(label + " vs gpu ref", got, on_gpu)
            e2, d2 = warp_tolerance_error(label + " vs cpu ref", got, on_cpu,
                                          WARP_MIN_EQUAL_CROSS)
            errors += [e for e in (e1, e2) if e]
            details.append(f"{label}: gpu {d1[0]:.0f}/{d1[1]:.5f} "
                           f"cpu {d2[0]:.0f}/{d2[1]:.5f}")
            n += 1
    if errors:
        raise AssertionError("; ".join(errors + details))
    return n, "; ".join(details)


def _applied_correction_fn(stab_params):
    """jit: the correction the last emitting step applied, read back from
    the state after it (the emission cursor stepped back by one). Exact
    for the box smoother, which keeps no state of its own."""
    import jax

    from video_stab_tpu.core.stabilizer import stabilizer_emit_correction_fn

    return jax.jit(lambda s: stabilizer_emit_correction_fn(
        stab_params, s._replace(emit_idx=s.emit_idx - 1))[1])


def _run_chain(chain, frames, correction_fn=None):
    """Frames through ProcessingChain.process; also the median wall time
    of one call over the second half (steady state, delivered to host),
    and with ``correction_fn`` the correction applied to each emission."""
    outs, times, corrections = [], [], []
    for f in frames:
        t0 = time.perf_counter()
        o = chain.process(f)
        times.append(time.perf_counter() - t0)
        if o is not None:
            outs.append(o)
            if correction_fn is not None:
                corrections.append(np.asarray(
                    correction_fn(chain._state.stab)))
    steady_ms = float(np.median(times[len(times) // 2:])) * 1e3
    return outs, chain._state, steady_ms, np.asarray(corrections)


def phase_chain_parity(ctx):
    """24 frames of the 1080p fused chain on the card and on the CPU:
    per-frame motion and applied correction, emitted frames, and the
    homography model."""
    import jax
    from scipy.linalg import expm

    from video_stab_tpu.core.chain import ProcessingChain

    frames = ctx.clip(24, *HD)
    details = []
    for model in ("similarity", "homography"):
        comps = chain_components(motion_model=model)
        corr_fn = _applied_correction_fn(comps[3])
        gpu_out, gpu_st, _, gpu_corr = _run_chain(
            ProcessingChain(*comps), frames, corr_fn)
        with jax.default_device(ctx.cpu):
            cpu_out, cpu_st, _, cpu_corr = _run_chain(
                ProcessingChain(*comps), frames, corr_fn)
        n_path = int(np.asarray(cpu_st.stab.n_path))
        tg = np.asarray(gpu_st.stab.trans_ring)[:n_path]
        tc = np.asarray(cpu_st.stab.trans_ring)[:n_path]
        if not cpu_out or len(gpu_out) != len(cpu_out):
            raise AssertionError(f"{model}: emitted gpu {len(gpu_out)} "
                                 f"cpu {len(cpu_out)}")
        if model == "similarity":
            motion = []
            for what, g, c in (("motion", tg, tc),
                               ("applied", gpu_corr, cpu_corr)):
                dxy = float(np.abs(g[:, :2] - c[:, :2]).max())
                da = float(np.abs(g[:, 2] - c[:, 2]).max())
                if dxy > CHAIN_MAX_DXY or da > CHAIN_MAX_DA:
                    raise AssertionError(f"similarity {what}: max|ddxy|={dxy}"
                                         f" max|dda|={da}")
                motion.append(f"{what} max|ddxy|={dxy:.2e} px "
                              f"max|dda|={da:.2e} rad")
            motion = ", ".join(motion)
        else:
            motion = []
            for what, g_all, c_all in (("motion", tg, tc),
                                       ("applied", gpu_corr, cpu_corr)):
                rel = max(
                    float(np.linalg.norm(expm(g.reshape(3, 3))
                                         - expm(c.reshape(3, 3)))
                          / np.linalg.norm(expm(c.reshape(3, 3))))
                    for g, c in zip(g_all, c_all))
                if rel > HOMOG_MAX_REL_FRO:
                    raise AssertionError(
                        f"homography {what}: rel Frobenius {rel}")
                motion.append(f"{what} max rel Frobenius {rel:.2e}")
            motion = ", ".join(motion)
        mean_abs = max(float(np.abs(a.astype(np.float32)
                                    - b.astype(np.float32)).mean())
                       for a, b in zip(gpu_out, cpu_out))
        if mean_abs > CHAIN_MAX_MEAN_ABS:
            raise AssertionError(f"{model}: frame mean|d| {mean_abs}")
        roll = float(np.asarray(gpu_st.roll.smoothed_angle))
        details.append(f"{model}: {n_path} transforms, {motion}, "
                       f"{len(cpu_out)} frames max mean|d|={mean_abs:.3f}, "
                       f"roll {roll:.2f} deg")
    return 2 * len(frames), "; ".join(details)


def phase_app(ctx):
    """StabilizerApp from an AppConfig object: synthetic 1080p source, null
    sink, fused chain, 120 frames through the `vstab run` call path."""
    import jax

    from video_stab_tpu.io.runner import StabilizerApp
    from video_stab_tpu.utils.config import AppConfig, CameraParams

    mode, enh, roll, stab = chain_components()
    cfg = AppConfig(video_source=f"synthetic:{HD[1]}x{HD[0]}",
                    output_source="null",
                    mode=mode, enhancer=enh, roll_correction=roll,
                    stabilizer=stab,
                    camera=CameraParams(threaded_queue_mode=False))
    app = StabilizerApp(cfg, max_frames=120)
    if app.chain is None or app.packet_mode:
        raise AssertionError("app did not build the fused frame graph")
    app.run(duration=900.0)
    if app._frames_out < 120:
        raise AssertionError(f"app emitted {app._frames_out} frames")
    devices = {d for leaf in jax.tree_util.tree_leaves(app.chain._state)
               for d in leaf.devices()}
    if devices != {ctx.gpu}:
        raise AssertionError(f"chain state on {devices}")
    return app._frames_out, f"{app._frames_out} frames out, state on {devices}"


def phase_chain_4k(ctx):
    """48 frames of the 3840x2160 fused chain."""
    from video_stab_tpu.core.chain import ProcessingChain

    frames = ctx.clip(48, *UHD)
    comps = chain_components()
    outs, _, steady_ms, _ = _run_chain(ProcessingChain(*comps), frames)
    # The first emission comes with the effective_radius-th frame.
    expect = len(frames) - comps[3].effective_radius + 1
    if len(outs) != expect or outs[0].shape != UHD + (3,):
        raise AssertionError(f"4K: {len(outs)} frames of {outs[0].shape}")
    return len(frames), (f"{len(outs)} frames emitted, steady "
                         f"{steady_ms:.2f} ms/frame delivered to host")


def _stream_batches(ctx, n_streams, ticks):
    clip = ctx.clip(240, *HD)
    for t in range(ticks):
        yield np.stack([clip[(t + 17 * k) % len(clip)]
                        for k in range(n_streams)])


def phase_batched(ctx):
    """MultiStreamStabilizer, 8 x 1080p streams, 48 ticks, one reset."""
    from video_stab_tpu.parallel import MultiStreamStabilizer

    stab = chain_components()[3]
    ms = MultiStreamStabilizer(stab, n_streams=8)
    emitted = np.zeros(8, np.int64)
    for t, batch in enumerate(_stream_batches(ctx, 8, 48)):
        if t == 24:
            ms.reset_stream(3)
        out = ms.stabilize_batch(batch)
        if out is not None:
            if out.shape != (8,) + HD + (3,):
                raise AssertionError(f"batch out {out.shape}")
            emitted += ms.last_valid
    if emitted.min() == 0 or emitted[3] >= emitted[0]:
        raise AssertionError(f"per-stream emissions {emitted.tolist()}")
    if ms.last_out_device.devices() != {ctx.gpu}:
        raise AssertionError(
            f"batched output on {ms.last_out_device.devices()}")
    return 8 * 48, f"emitted per stream {emitted.tolist()}"


def phase_offline(ctx):
    """offline.stabilize_clip on 240 frames of 1080p, box and l1."""
    from video_stab_tpu.core.params import StabilizerParams
    from video_stab_tpu.offline import stabilize_clip

    clip = ctx.clip(240, *HD)

    def jitter(frames):
        h, w = frames.shape[1:3]
        c = frames[:, h // 5:-h // 5, w // 6:-w // 6].astype(np.float32)
        return float(np.abs(np.diff(c, axis=0)).mean())

    j_in = jitter(clip)
    details = [f"input jitter {j_in:.2f}"]
    for method in ("box", "l1"):
        out = stabilize_clip(clip, StabilizerParams(smoothing_radius=15,
                                                    smoothing_method=method))
        if out.shape != clip.shape:
            raise AssertionError(f"{method}: out {out.shape}")
        j = jitter(out)
        if not j < j_in:
            raise AssertionError(f"{method}: jitter {j} >= input {j_in}")
        details.append(f"{method} jitter {j:.2f}")
    return 2 * len(clip), ", ".join(details)


def phase_four_cards(ctx):
    """8 x 1080p streams sharded 2 per card over a 4-card stream mesh,
    against the same streams on one card.

    The two programs are compiled for different per-device batches (2 and
    8), so XLA's fusion and reduction order differ and the per-stream
    motion estimates differ in the last bits; they are held to the chain
    parity tolerances (motion and per-frame mean |d|) and to the warp's
    max |d|, with the identical share reported beside them (PERF.md)."""
    import jax

    from video_stab_tpu.parallel import MultiStreamStabilizer, make_stream_mesh

    if len(jax.devices()) < 4:
        raise AssertionError(f"needs 4 GPUs, {len(jax.devices())} present")
    stab = chain_components()[3]
    mesh = make_stream_mesh(jax.devices()[:4])
    sharded = MultiStreamStabilizer(stab, n_streams=8, mesh=mesh)
    single = MultiStreamStabilizer(stab, n_streams=8)
    compared, worst = 0, [0.0, 1.0, 0.0]      # max|d|, identical, mean|d|
    for batch in _stream_batches(ctx, 8, 24):
        a = sharded.stabilize_batch(batch)
        b = single.stabilize_batch(batch)
        if (a is None) != (b is None):
            raise AssertionError("sharded and single-card warm-up differ")
        if a is None:
            continue
        dmax, same = compare_u8(a, b)
        mean = max(float(np.abs(a[k].astype(np.float32)
                                - b[k].astype(np.float32)).mean())
                   for k in range(8))
        worst = [max(worst[0], dmax), min(worst[1], same),
                 max(worst[2], mean)]
        compared += 1
    if compared == 0:
        raise AssertionError("no emitted ticks to compare")
    n_path = int(np.asarray(single._state.n_path).min())
    ta = np.asarray(sharded._state.trans_ring)[:, :n_path]
    tb = np.asarray(single._state.trans_ring)[:, :n_path]
    dxy = float(np.abs(ta[..., :2] - tb[..., :2]).max())
    da = float(np.abs(ta[..., 2] - tb[..., 2]).max())
    detail = (f"{compared} ticks compared: max|ddxy|={dxy:.2e} px "
              f"max|dda|={da:.2e} rad, frames max mean|d|={worst[2]:.4f} "
              f"max|d|={worst[0]:.0f} identical>={worst[1]:.5f}")
    if dxy > CHAIN_MAX_DXY or da > CHAIN_MAX_DA \
            or worst[2] > CHAIN_MAX_MEAN_ABS or worst[0] > WARP_MAX_ABS:
        raise AssertionError(detail)
    for name, arr in (("out", sharded.last_out_device),
                      ("frame_ring", sharded._state.frame_ring)):
        shards = arr.addressable_shards
        seen = {s.device for s in shards}
        if len(shards) != 4 or len(seen) != 4 or any(
                s.data.shape[0] != 2 for s in shards):
            raise AssertionError(
                f"{name}: shards {[(s.device, s.data.shape) for s in shards]}")
    return 2 * 8 * 24, detail + ", 2 streams per card"


PHASES = (("warp_parity", phase_warp),
          ("chain_parity", phase_chain_parity),
          ("served_app", phase_app),
          ("chain_4k", phase_chain_4k),
          ("batched_streams", phase_batched),
          ("offline", phase_offline))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card stream-sharded phase")
    args = ap.parse_args(argv)
    print("card:", card_line(), flush=True)

    import jax

    from video_stab_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    try:
        gpu = require_gpu()
    except RuntimeError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    print(f"device: {gpu.platform} {gpu.device_kind} x{len(jax.devices())}"
          f"; matmul precision: HIGHEST at every f32 product "
          f"(jax_default_matmul_precision="
          f"{jax.config.jax_default_matmul_precision})", flush=True)
    ctx = Ctx(args.seed)
    phases = ((("four_cards", phase_four_cards),) if args.four_cards
              else PHASES)
    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            frames, detail = fn(ctx)
        except Exception as e:  # noqa: BLE001 - every phase is reported
            import traceback

            traceback.print_exc()
            failed.append(name)
            print(f"[{name}] FAILED after {time.perf_counter() - t0:.1f} s: "
                  f"{type(e).__name__}: {e}", flush=True)
            continue
        dt = time.perf_counter() - t0
        print(f"[{name}] ok {dt:.1f} s, {frames} frames, "
              f"{dt / max(frames, 1) * 1e3:.1f} ms/frame (compile included)"
              f" | {detail}", flush=True)
    if failed:
        print(f"chip_smoke: failed phases: {', '.join(failed)}",
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": gpu.platform, "kind": gpu.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
