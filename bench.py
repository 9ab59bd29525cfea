"""Benchmark: steady-state stabilized frames/sec on one GPU.

    python bench.py [--config NAME]

Runs its configurations one after another in this one process (one JAX
process per card) and prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...,
   "platform": ..., "device_kind": ..., "device_count": N}

Primary metric: stabilized 1080p frames/sec for the full combined
analyze+emit step, measured DISPATCH-AMORTIZED: one jitted program runs
`lax.scan` over K frames (donated state, frame pool resident on device),
so one dispatch covers K frames and the timing reflects device compute
rather than per-dispatch host overhead. Per-dispatch latency and
delivered-to-host rates are measured separately. Baseline: the
reference's 30 fps design rate on its target hardware (Jetson Orin Nano;
BASELINE.md - GstdManager.h:24, RTSPServer.h:16), so vs_baseline = fps/30.

Without a GPU backend the script refuses to run unless JAX_PLATFORMS=cpu
asks for the CPU explicitly; every number it prints names its device.
"""

from __future__ import annotations

import json
import time

import numpy as np

SCAN_K_1080 = 240     # frames per dispatch (8 s of 30 fps video)
SCAN_K_4K = 120
SCAN_K_MULTI = 120
SCAN_K_CHAIN = 240


def _make_pool(h, w, n=4, seed=0):
    """Textured jittered frame pool — realistic content for the
    data-dependent paths (GFTT frontier depth, LK convergence), unlike a
    noise pool. A smooth random world viewed through a jittering window,
    mirroring tests/conftest.make_textured."""
    rng = np.random.default_rng(seed)
    pad = 32
    world = rng.random((h + 2 * pad, w + 2 * pad)).astype(np.float32)
    kern = np.exp(-0.5 * (np.arange(-6, 7) / 2.0) ** 2)
    kern /= kern.sum()
    world = np.apply_along_axis(
        lambda r: np.convolve(r, kern, mode="same"), 1, world)
    world = np.apply_along_axis(
        lambda c: np.convolve(c, kern, mode="same"), 0, world)
    world -= world.min()
    world /= max(world.max(), 1e-6)
    world = (world * 255.0).astype(np.uint8)
    frames = []
    for i in range(n):
        dx, dy = rng.integers(-8, 9, 2)
        f = world[pad + dy:pad + dy + h, pad + dx:pad + dx + w]
        frames.append(np.stack([f, np.roll(f, 1, 0), 255 - f], axis=-1))
    return np.stack(frames)


def _bench_scan(h, w, k, n_iters, smoothing_radius=15, n_streams=1,
                extra_params=None):
    """Scan-amortized steady-state throughput.

    Returns (fps_aggregate, ms_per_frame_amortized). One dispatch = `k`
    combined analyze+emit steps via lax.scan; the 4-frame input pool is a
    closed-over jit constant (device-resident, never re-streamed); state is
    donated. Warm-up (the look-ahead gate) happens inside the first
    dispatch since k >= effective_radius.
    """
    import jax
    import jax.numpy as jnp

    from video_stab_tpu.core.params import StabilizerParams
    from video_stab_tpu.core.state import stabilizer_state_init
    from video_stab_tpu.core.stabilizer import stabilizer_step_fn

    params = StabilizerParams(
        smoothing_radius=smoothing_radius,
        # vmapped conds run both branches; GFTT's single-branch variant
        # is the cond-free staged extraction (ops/features.py).
        gftt_topk="staged" if n_streams > 1 else "auto",
        **(extra_params or {}))
    assert k >= params.effective_radius + 1
    # The pool is a jit ARGUMENT (device-resident across calls), not a
    # closed-over multi-MB constant baked into the program.
    pool = jax.device_put(jnp.asarray(_make_pool(h, w)))

    def one_step(st, frame):
        st, out, _ready = stabilizer_step_fn(params, st, frame)
        # Force the emit (keeps it live past DCE) at one-row cost - the
        # serving path hands `out` to the encoder, it never reduces it.
        return st, jnp.mean(out[0].astype(jnp.float32))

    if n_streams == 1:
        state = stabilizer_state_init(params, h, w)

        def step(st, frame, i):
            return one_step(st, frame)
    else:
        from video_stab_tpu.parallel import batched_state_init
        state = batched_state_init(params, n_streams, h, w)

        def one_step_tick(st, frame, tick):
            st, out, _ready = stabilizer_step_fn(params, st, frame,
                                                 redetect_tick=tick)
            return st, jnp.mean(out[0].astype(jnp.float32))

        # The scan counter rides unbatched as the redetect tick — keeps
        # the redetect lax.cond's predicate SCALAR under vmap (a batched
        # predicate would run GFTT every frame + select).
        vstep = jax.vmap(one_step_tick, in_axes=(0, None, None))

        def step(st, frame, i):
            st, m = vstep(st, frame, i)
            return st, jnp.mean(m)

    def scan_fn(st, frame_pool):
        def body(carry, i):
            frame = jax.lax.dynamic_index_in_dim(
                frame_pool, i % 4, keepdims=False)
            return step(carry, frame, i)

        st, means = jax.lax.scan(body, st, jnp.arange(k, dtype=jnp.int32))
        return st, jnp.mean(means)

    scan_jit = jax.jit(scan_fn, donate_argnums=0)
    state = jax.device_put(state, jax.devices()[0])
    compiled = scan_jit.lower(state, pool).compile()

    state, m = compiled(state, pool)    # warm-up (in-graph gate) + warm
    float(m)
    state, m = compiled(state, pool)
    float(m)
    t0 = time.perf_counter()
    for _ in range(n_iters):
        state, m = compiled(state, pool)
    float(m)
    dt = time.perf_counter() - t0
    frames = n_iters * k * n_streams
    return frames / dt, dt / (n_iters * k) * 1e3


def _bench_scan_chain(h, w, k, n_iters, smoothing_radius=15):
    """Scan-amortized throughput of the FUSED SERVING CHAIN
    (enhance + roll-correct + stabilize — what `entry()` ships and
    vsg.cpp:1246-1313 runs per frame), not just the stabilizer step."""
    import jax
    import jax.numpy as jnp

    from video_stab_tpu.core.chain import (ChainParams, chain_gated_step_fn,
                                           chain_state_init)
    from video_stab_tpu.core.params import (EnhancerParams, ModeParams,
                                            RollCorrectionParams,
                                            StabilizerParams)

    params = ChainParams(
        mode=ModeParams(enhancer_enabled=True, roll_correction_enabled=True,
                        stabilizer_enabled=True),
        enhancer=EnhancerParams(), roll=RollCorrectionParams(),
        stabilizer=StabilizerParams(smoothing_radius=smoothing_radius))
    pool_np = _make_pool(h, w).astype(np.float32)
    # Composite a ~2 deg tilted horizon edge so the roll stage actually
    # ENGAGES (Canny+Hough find the line, the smoothed angle settles
    # near -2, and the fused emit warp composes a real rotation) — a
    # line-free pool would idle the roll path at alpha == 0 and measure
    # nothing.
    yy = np.arange(h, dtype=np.float32)[None, :, None, None]
    xx = np.arange(w, dtype=np.float32)[None, None, :, None]
    sky = yy < (h / 2.0 + np.tan(np.radians(2.0)) * (xx - w / 2.0))
    pool_np = np.clip(pool_np * 0.75 + sky * 60.0, 0, 255).astype(np.uint8)
    pool = jax.device_put(jnp.asarray(pool_np))

    def scan_fn(st, frame_pool):
        def body(carry, i):
            frame = jax.lax.dynamic_index_in_dim(
                frame_pool, i % 4, keepdims=False)
            carry, out, _ready = chain_gated_step_fn(params, carry, frame)
            return carry, jnp.mean(out[0].astype(jnp.float32))

        st, means = jax.lax.scan(body, st, jnp.arange(k, dtype=jnp.int32))
        return st, jnp.mean(means)

    scan_jit = jax.jit(scan_fn, donate_argnums=0)
    state = jax.device_put(chain_state_init(params, h, w), jax.devices()[0])
    compiled = scan_jit.lower(state, pool).compile()

    state, m = compiled(state, pool)
    float(m)
    state, m = compiled(state, pool)
    float(m)
    t0 = time.perf_counter()
    for _ in range(n_iters):
        state, m = compiled(state, pool)
    float(m)
    dt = time.perf_counter() - t0
    return (n_iters * k) / dt, dt / (n_iters * k) * 1e3


def _bench_dispatch(h, w, n_iters, smoothing_radius=15, mode="compute"):
    """Per-dispatch single-frame measurement (true per-frame latency a
    real-time single stream pays: one RPC per frame). mode="full" returns
    the whole stabilized BGR frame to the host (delivered-mode cost);
    mode="yuv" folds the BT.601 I420 conversion into the same program and
    delivers the planar YUV buffer — HALF the D2H bytes, and the format
    the encoder consumes directly."""
    import jax
    import jax.numpy as jnp

    from video_stab_tpu.core.params import StabilizerParams
    from video_stab_tpu.core.state import stabilizer_state_init
    from video_stab_tpu.core.stabilizer import stabilizer_step_fn
    from video_stab_tpu.ops.color import bgr_to_i420

    def scalar_step_fn(params, state, frame):
        state, out, _ready = stabilizer_step_fn(params, state, frame)
        return state, jnp.mean(out[0].astype(jnp.float32))

    def yuv_step_fn(params, state, frame):
        state, out, _ready = stabilizer_step_fn(params, state, frame)
        return state, bgr_to_i420(out)

    fn = {"full": stabilizer_step_fn, "yuv": yuv_step_fn}.get(
        mode, scalar_step_fn)
    step = jax.jit(fn, static_argnums=0, donate_argnums=1)

    params = StabilizerParams(smoothing_radius=smoothing_radius)
    state = jax.device_put(stabilizer_state_init(params, h, w),
                           jax.devices()[0])
    rng = np.random.default_rng(0)
    frames = [jax.device_put(rng.integers(0, 255, (h, w, 3), dtype=np.uint8))
              for _ in range(4)]
    jax.block_until_ready(frames)

    def force(r):
        # Force actual completion by materializing a value.
        if mode in ("full", "yuv"):
            np.asarray(r[0])
        else:
            float(r[0])

    res = None
    for i in range(params.effective_radius + 1):
        state, *res = step(params, state, frames[i % 4])
    force(res)
    t0 = time.perf_counter()
    for i in range(n_iters):
        state, *res = step(params, state, frames[i % 4])
        if mode in ("full", "yuv"):
            np.asarray(res[0])      # host must actually receive it
    force(res)
    dt = time.perf_counter() - t0
    return n_iters / dt, dt / n_iters * 1e3


def _bench_end_to_end(h, w, n_frames=240, fps_in=30, output_format="i420",
                      stages=True):
    """TRUE end-to-end serving rate: H.264 decode (native libavcodec) ->
    fused chain on device -> H.264 encode, threads overlapping host decode
    / device compute / host encode (the reference's full loop,
    CamCap.cpp:141-256 + vsg.cpp:1246-1313, which it runs at 30 fps with
    50-100 ms latency — README_GSTD_INTERPIPE.md:158).

    output_format="i420": the chain converts to planar YUV ON DEVICE (half
    the D2H payload) and the encoder takes it with no swscale pass
    `stages=True` additionally times each stage SOLO —
    decode-only, device-step-only (incl. the delivered transfer),
    encode-only — so the record shows the pipeline shape: with proper
    overlap, e2e ms/frame ~ max(stage), not sum(stage).

    Returns (fps_end_to_end, ms_per_frame, stage_dict)."""
    import os
    import queue
    import tempfile
    import threading

    from video_stab_tpu.core.chain import ProcessingChain
    from video_stab_tpu.core.params import (EnhancerParams, ModeParams,
                                            RollCorrectionParams,
                                            StabilizerParams)
    from video_stab_tpu.io.codec import VideoDecoder, VideoEncoder
    from video_stab_tpu.io.packets import PacketSource
    from video_stab_tpu.io.sinks import bitrate_bps_app

    bps = bitrate_bps_app(w, h, fps_in)
    pool = _make_pool(h, w, n=8)

    clip = os.path.join(tempfile.gettempdir(), f"bench_e2e_{h}p.h264")
    enc0 = VideoEncoder(w, h, fps_in, bitrate_bps=bps, gop=30,
                        zerolatency=True)
    with open(clip, "wb") as f:
        for i in range(n_frames):
            f.write(enc0.encode(pool[i % len(pool)]))
        f.write(enc0.flush())
    enc0.close()

    chain = ProcessingChain(
        ModeParams(enhancer_enabled=True, roll_correction_enabled=True,
                   stabilizer_enabled=True),
        EnhancerParams(), RollCorrectionParams(),
        StabilizerParams(smoothing_radius=15), pipelined=True,
        output_format=output_format)
    is_i420 = output_format == "i420"

    stage = {}
    if stages:
        # --- decode-only: the full clip through the native decoder.
        dec = VideoDecoder()
        src = PacketSource(clip)
        head = []
        n_dec = 0
        t0 = time.perf_counter()
        while (au := src.read()) is not None:
            for fr in dec.decode(b"".join(au)):
                n_dec += 1
                if len(head) < 8:
                    head.append(fr[:, :, :3].copy())
        n_dec += len(dec.flush())
        stage["decode_ms"] = \
            (time.perf_counter() - t0) / max(n_dec, 1) * 1e3
        dec.close()
        src.stop()

        # --- device-only: per-dispatch chain step + delivered transfer
        # (what the processing thread pays per frame, nothing overlapped).
        n_dev = min(n_frames, 48)
        outs = []
        for i in range(20):             # warm-up past the look-ahead gate
            o = chain.process(head[i % len(head)])
            if o is not None and len(outs) < 8:
                outs.append(o)
        t0 = time.perf_counter()
        got = 0
        for i in range(n_dev):
            o = chain.process(head[i % len(head)])
            if o is not None:
                got += 1
        stage["device_ms"] = \
            (time.perf_counter() - t0) / max(got, 1) * 1e3
        chain.clean()

        # --- encode-only: the x264 leg on real processed outputs.
        ence = VideoEncoder(w, h, fps_in, bitrate_bps=bps, zerolatency=True)
        n_enc = min(n_frames, 96)
        t0 = time.perf_counter()
        for i in range(n_enc):
            fr = np.ascontiguousarray(outs[i % len(outs)])
            if is_i420:
                ence.encode_yuv(fr)
            else:
                ence.encode(fr)
        stage["encode_ms"] = (time.perf_counter() - t0) / n_enc * 1e3
        ence.close()
        chain = ProcessingChain(
            ModeParams(enhancer_enabled=True, roll_correction_enabled=True,
                       stabilizer_enabled=True),
            EnhancerParams(), RollCorrectionParams(),
            StabilizerParams(smoothing_radius=15), pipelined=True,
            output_format=output_format)

    q_in: "queue.Queue" = queue.Queue(maxsize=8)
    q_out: "queue.Queue" = queue.Queue(maxsize=8)
    enc_bytes = [0]
    worker_err: list = []       # a dead worker fails the config

    def decode_loop():
        try:
            dec = VideoDecoder()
            src = PacketSource(clip)
            while (au := src.read()) is not None:
                for fr in dec.decode(b"".join(au)):
                    q_in.put(fr)
            for fr in dec.flush():
                q_in.put(fr)
            dec.close()
            src.stop()
        except Exception as e:
            worker_err.append(f"decode: {e!r}")
        finally:
            try:
                q_in.put(None, timeout=10)
            except queue.Full:
                pass

    def encode_loop():
        try:
            enc = VideoEncoder(w, h, fps_in, bitrate_bps=bps,
                               zerolatency=True)
            while (fr := q_out.get()) is not None:
                fr = np.ascontiguousarray(fr)
                enc_bytes[0] += len(enc.encode_yuv(fr) if is_i420
                                    else enc.encode(fr))
            enc_bytes[0] += len(enc.flush())
            enc.close()
        except Exception as e:
            worker_err.append(f"encode: {e!r}")
            while q_out.get() is not None:
                pass        # keep draining so the producer never blocks

    td = threading.Thread(target=decode_loop, daemon=True)
    te = threading.Thread(target=encode_loop, daemon=True)
    delivered = 0
    t0 = time.perf_counter()
    td.start()
    te.start()
    while True:
        try:
            fr = q_in.get(timeout=120.0)
        except queue.Empty:         # host decode can't take minutes —
            worker_err.append("decode stalled")     # a wedged worker
            break
        if fr is None:
            break
        out = chain.process(fr[:, :, :3])
        if out is not None:
            q_out.put(out)
            delivered += 1
    tail = chain.drain()
    if tail is not None:
        q_out.put(tail)
        delivered += 1
    q_out.put(None)
    te.join(timeout=120.0)
    td.join(timeout=10.0)
    dt = time.perf_counter() - t0
    if worker_err:
        import sys
        sys.stderr.write(f"e2e worker failure: {worker_err}\n")
        try:
            os.unlink(clip)
        except OSError:
            pass
        return None, None, stage
    try:
        os.unlink(clip)
    except OSError:
        pass
    if delivered == 0:
        return None, None, stage
    ms = dt / delivered * 1e3
    if stages and all(k in stage for k in ("decode_ms", "device_ms",
                                           "encode_ms")):
        # 1.0 = perfectly overlapped pipeline (e2e == slowest stage);
        # 1/n_stages = fully serial.
        stage["overlap_factor"] = round(
            max(stage["decode_ms"], stage["device_ms"],
                stage["encode_ms"]) / ms, 3)
        stage = {k: round(v, 3) for k, v in stage.items()}
    stage["output_format"] = output_format
    return delivered / dt, ms, stage


def _rounded(x, nd):
    return round(x, nd) if x else None


def _run(name, fn, errors):
    """One configuration; a failure is recorded and does not stop the
    rest."""
    import sys

    t0 = time.perf_counter()
    try:
        res = fn()
    except Exception as e:  # noqa: BLE001 - reported in the record
        errors[name] = f"{type(e).__name__}: {e}"[:300]
        sys.stderr.write(f"[bench] {name} failed: {errors[name]}\n")
        return None
    sys.stderr.write(f"[bench] {name}: {res} "
                     f"({time.perf_counter() - t0:.1f} s)\n")
    return res


CONFIGS = {
    "1080": lambda: _bench_scan(1080, 1920, SCAN_K_1080, 2),
    "4k": lambda: _bench_scan(2160, 3840, SCAN_K_4K, 2),
    "multi": lambda: _bench_scan(1080, 1920, SCAN_K_MULTI, 2, n_streams=8),
    "chain": lambda: _bench_scan_chain(1080, 1920, SCAN_K_CHAIN, 2),
    # BASELINE.json's "END-TO-END 4K stabilization" target: the fused
    # enhance+roll+stabilize chain at 4K.
    "chain4k": lambda: _bench_scan_chain(2160, 3840, SCAN_K_4K, 2),
    # The 8-DOF projective motion model (beyond-reference feature).
    "homog": lambda: _bench_scan(1080, 1920, SCAN_K_1080, 2,
                                 extra_params=dict(motion_model="homography")),
    "dispatch": lambda: _bench_dispatch(1080, 1920, 30),
    "delivered": lambda: _bench_dispatch(1080, 1920, 30, mode="full"),
    "delivered_yuv": lambda: _bench_dispatch(1080, 1920, 30, mode="yuv"),
    "e2e": lambda: _bench_end_to_end(1080, 1920, n_frames=120),
}


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", choices=sorted(CONFIGS),
                    help="run one configuration and print its result")
    args = ap.parse_args(argv)

    import jax

    from video_stab_tpu.utils.cache import enable_compilation_cache
    from video_stab_tpu.utils.device import require_gpu

    enable_compilation_cache()
    dev = require_gpu()
    device = {"platform": dev.platform, "device_kind": dev.device_kind,
              "device_count": len(jax.devices())}
    errors: dict = {}
    if args.config:
        res = _run(args.config, CONFIGS[args.config], errors)
        print(json.dumps({"config": args.config, "result": res,
                          "errors": errors or None, **device}))
        return 0 if res is not None else 1

    r = {name: _run(name, fn, errors) for name, fn in CONFIGS.items()}

    def fps(name):
        return r[name][0] if r[name] else None

    def ms(name):
        return r[name][1] if r[name] else None

    e2e_stages = r["e2e"][2] if r["e2e"] else None
    fps_1080 = fps("1080")
    out = {
        "metric": "stabilized_fps_1080p",
        "value": _rounded(fps_1080, 2),
        "unit": "frames/sec/device",
        "vs_baseline": _rounded(fps_1080 and fps_1080 / 30.0, 3),
        "ms_per_frame_1080p_amortized": _rounded(ms("1080"), 4),
        "fps_4k": _rounded(fps("4k"), 2),
        "ms_per_frame_4k_amortized": _rounded(ms("4k"), 4),
        "fps_8x1080p_aggregate": _rounded(fps("multi"), 2),
        "fps_1080p_chain": _rounded(fps("chain"), 2),
        "ms_per_frame_1080p_chain": _rounded(ms("chain"), 4),
        "fps_4k_chain": _rounded(fps("chain4k"), 2),
        "ms_per_frame_4k_chain": _rounded(ms("chain4k"), 4),
        "fps_1080p_homography": _rounded(fps("homog"), 2),
        "ms_per_frame_1080p_homography": _rounded(ms("homog"), 4),
        "scan_frames_per_dispatch": SCAN_K_1080,
        "p50_ms_per_frame_1080p_per_dispatch": _rounded(ms("dispatch"), 3),
        "fps_1080p_delivered_to_host": _rounded(fps("delivered"), 2),
        "fps_1080p_delivered_yuv": _rounded(fps("delivered_yuv"), 2),
        "fps_1080p_end_to_end": _rounded(fps("e2e"), 2),
        "ms_per_frame_1080p_end_to_end": _rounded(ms("e2e"), 3),
        "e2e_stages": e2e_stages or None,
        "errors": errors or None,
        **device,
    }
    print(json.dumps(out))
    return 0 if fps_1080 else 1


if __name__ == "__main__":
    raise SystemExit(main())
