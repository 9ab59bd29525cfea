"""Command-line interface.

The reference's CLI surface is `./app <config.yaml>` (vsg.cpp:1167-1171);
here:

  python -m video_stab_tpu.cli run <config.yaml> [--duration S] [--frames N]
                                    [--rest] [--tcp]
  python -m video_stab_tpu.cli stabilize <in.mp4> <out.mp4> [--radius N] ...
  python -m video_stab_tpu.cli offline <in.mp4> <out.mp4> [--method l1]
  python -m video_stab_tpu.cli selftest            # synthetic end-to-end run
  python -m video_stab_tpu.cli bench               # one-JSON-line benchmark
  python -m video_stab_tpu.cli train-detector      # short synthetic training
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _quiet_cv2():
    try:
        import cv2
        cv2.setNumThreads(0)
    except Exception:
        pass


def cmd_run(args) -> int:
    _quiet_cv2()
    from video_stab_tpu.io.runner import run_app

    pkt = {"auto": None, "on": True, "off": False}[args.packet]
    app = run_app(args.config, enable_rest=args.rest, enable_tcp=args.tcp,
                  max_frames=args.frames, packet_mode=pkt)
    print(f"[cli] running {args.config} "
          f"(duration={args.duration or 'inf'}s frames={args.frames or 'inf'}"
          f" packet_mode={app.packet_mode})")
    app.run(duration=args.duration)
    snap = app.metrics.snapshot()
    print(json.dumps(snap, indent=2, default=str))
    return 0


def cmd_stabilize(args) -> int:
    """File in -> stabilized file out (the roll-correction-file.cpp /
    file-capture.cpp style one-shot path)."""
    _quiet_cv2()
    import cv2

    from video_stab_tpu.core.params import StabilizerParams
    from video_stab_tpu.core.stabilizer import Stabilizer
    from video_stab_tpu.io.sinks import open_sink

    cap = cv2.VideoCapture(args.input)
    if not cap.isOpened():
        print(f"cannot open {args.input}", file=sys.stderr)
        return 1
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    st = Stabilizer(StabilizerParams(
        smoothing_radius=args.radius, border_type=args.border,
        border_size=args.border_size, crop_n_zoom=args.crop,
        smoothing_method=args.method))
    sink = open_sink(args.output, fps=fps)
    n_in = n_out = 0
    t0 = time.perf_counter()
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        n_in += 1
        out = st.stabilize(frame)
        if out is not None:
            sink.write(out)
            n_out += 1
    while (out := st.flush()) is not None:
        sink.write(out)
        n_out += 1
    sink.close()
    cap.release()
    dt = time.perf_counter() - t0
    print(json.dumps({"frames_in": n_in, "frames_out": n_out,
                      "seconds": round(dt, 2),
                      "fps": round(n_in / dt, 1) if dt else 0.0}))
    return 0


def cmd_offline(args) -> int:
    """Whole-clip batch stabilization (the throughput mode; supports the
    cinematic --method l1 path)."""
    _quiet_cv2()
    import cv2
    import numpy as np

    from video_stab_tpu.core.params import StabilizerParams
    from video_stab_tpu.io.sinks import open_sink
    from video_stab_tpu.offline import stabilize_clip

    cap = cv2.VideoCapture(args.input)
    if not cap.isOpened():
        print(f"cannot open {args.input}", file=sys.stderr)
        return 1
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok or (args.max_frames and len(frames) >= args.max_frames):
            break
        frames.append(frame)
    cap.release()
    if not frames:
        print("no frames decoded", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    out = stabilize_clip(np.stack(frames), StabilizerParams(
        smoothing_radius=args.radius, smoothing_method=args.method,
        border_size=args.border_size, crop_n_zoom=args.crop))
    dt = time.perf_counter() - t0
    sink = open_sink(args.output, fps=fps)
    for f in out:
        sink.write(f)
    sink.close()
    print(json.dumps({"frames": len(frames), "seconds": round(dt, 2),
                      "fps": round(len(frames) / dt, 1)}))
    return 0


def cmd_selftest(args) -> int:
    """Synthetic end-to-end run: synthetic source -> full processing chain ->
    null sink, with hot-reload exercised. No hardware, no files."""
    _quiet_cv2()
    import numpy as np

    from video_stab_tpu.core.params import (
        EnhancerParams,
        RollCorrectionParams,
        StabilizerParams,
    )
    from video_stab_tpu.core.enhancer import Enhancer
    from video_stab_tpu.core.rollcorrection import RollCorrection
    from video_stab_tpu.core.stabilizer import Stabilizer
    from video_stab_tpu.io.sources import SourceParams, SyntheticSource

    # Synchronous read: the first stabilize() call compiles (slow on CPU)
    # and a threaded bounded queue would — correctly — drop frames under
    # that backpressure, which is not what a selftest should measure.
    src = SyntheticSource(SourceParams(source="synthetic",
                                       threaded_queue_mode=False),
                          height=96, width=128, n_frames=16, seed=1).start()
    en = Enhancer(EnhancerParams(brightness=5.0, contrast=1.1, gamma=0.95))
    roll = RollCorrection(RollCorrectionParams(scale_factor=0.5))
    st = Stabilizer(StabilizerParams(
        smoothing_radius=5, analysis_width=128, analysis_height=96,
        max_corners=64, ransac_hypotheses=64))
    n_out = 0
    for i in range(16):
        frame = src.read(timeout=2.0)
        if frame is None:
            break
        frame = en.enhance(frame)
        frame = roll.auto_correct_roll(frame)
        out = st.stabilize(frame)
        if out is not None:
            n_out += 1
    while st.flush() is not None:
        n_out += 1
    src.stop()
    ok = n_out >= 12
    print(json.dumps({"selftest": "ok" if ok else "FAIL",
                      "frames_out": n_out}))
    return 0 if ok else 1


def cmd_bench(args) -> int:
    # bench.py lives at the repo root (a measurement harness, not package
    # code); a bare import only resolves with cwd=repo-root, so fall back
    # to the location relative to this file for any other cwd.
    try:
        import bench
    except ModuleNotFoundError:
        import importlib.util
        import os
        path = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "bench.py")
        if not os.path.exists(path):
            print(json.dumps({"error": "bench.py not found (repo-root "
                                       "harness; not shipped in installs)"}))
            return 1
        spec = importlib.util.spec_from_file_location("bench", path)
        bench = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(bench)
    return bench.main([])


def cmd_train_detector(args) -> int:
    from video_stab_tpu.models.train import train_detector

    _, _, losses = train_detector(n_steps=args.steps, batch=args.batch,
                                  log_every=max(args.steps // 5, 1))
    print(json.dumps({"steps": args.steps, "first_loss": round(losses[0], 4),
                      "last_loss": round(losses[-1], 4)}))
    return 0 if losses[-1] < losses[0] else 1


def cmd_train_deepstab(args) -> int:
    _quiet_cv2()
    from video_stab_tpu.models.train import train_deepstab

    _, _, losses = train_deepstab(n_steps=args.steps, batch=args.batch,
                                  log_every=max(args.steps // 5, 1),
                                  save_path=args.out)
    print(json.dumps({"steps": args.steps, "first_loss": round(losses[0], 4),
                      "last_loss": round(losses[-1], 4),
                      "saved": args.out or None}))
    return 0


def cmd_profile(args) -> int:
    """Capture a jax.profiler trace of the steady-state chain step
    (view with TensorBoard / xprof)."""
    import numpy as np

    import jax

    from video_stab_tpu.core.params import StabilizerParams
    from video_stab_tpu.core.stabilizer import stabilizer_step
    from video_stab_tpu.core.state import stabilizer_state_init

    p = StabilizerParams(smoothing_radius=15)
    st = stabilizer_state_init(p, args.height, args.width)
    rng = np.random.default_rng(0)
    frame = jax.device_put(rng.integers(
        0, 255, (args.height, args.width, 3), dtype=np.uint8))
    for _ in range(p.effective_radius + 2):   # compile + warm
        st, out, _ready = stabilizer_step(p, st, frame)
    jax.block_until_ready(out)
    jax.profiler.start_trace(args.logdir)
    for _ in range(args.frames):
        st, out, _ready = stabilizer_step(p, st, frame)
    jax.block_until_ready(out)
    jax.profiler.stop_trace()
    print(json.dumps({"trace": args.logdir, "frames": args.frames}))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="vstab",
                                description="Real-time video stabilization")
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("run", help="run from a YAML config (vsg.cpp mode)")
    pr.add_argument("config")
    pr.add_argument("--duration", type=float, default=0.0)
    pr.add_argument("--frames", type=int, default=0)
    pr.add_argument("--rest", action="store_true")
    pr.add_argument("--tcp", action="store_true")
    pr.add_argument("--packet", choices=("auto", "on", "off"),
                    default="auto",
                    help="compressed-domain graph (auto: when source and "
                         "output are both H.264-capable)")
    pr.set_defaults(fn=cmd_run)

    ps = sub.add_parser("stabilize", help="stabilize a video file")
    ps.add_argument("input")
    ps.add_argument("output")
    ps.add_argument("--radius", type=int, default=15)
    ps.add_argument("--border", default="black")
    ps.add_argument("--border-size", type=int, default=0, dest="border_size")
    ps.add_argument("--crop", action="store_true")
    ps.add_argument("--method", default="box",
                    choices=["box", "gaussian", "kalman", "butterworth"])
    ps.set_defaults(fn=cmd_stabilize)

    po = sub.add_parser("offline", help="batch-stabilize a whole clip")
    po.add_argument("input")
    po.add_argument("output")
    po.add_argument("--radius", type=int, default=15)
    po.add_argument("--method", default="l1",
                    choices=["box", "gaussian", "kalman", "butterworth",
                             "l1"])
    po.add_argument("--border-size", type=int, default=0, dest="border_size")
    po.add_argument("--crop", action="store_true")
    po.add_argument("--max-frames", type=int, default=0, dest="max_frames")
    po.set_defaults(fn=cmd_offline)

    pt = sub.add_parser("selftest", help="synthetic end-to-end run")
    pt.set_defaults(fn=cmd_selftest)

    pb = sub.add_parser("bench", help="throughput benchmark (one JSON line)")
    pb.set_defaults(fn=cmd_bench)

    pd = sub.add_parser("train-detector", help="short synthetic training run")
    pd.add_argument("--steps", type=int, default=30)
    pd.add_argument("--batch", type=int, default=8)
    pd.set_defaults(fn=cmd_train_detector)

    pds = sub.add_parser("train-deepstab",
                         help="self-supervised deepstab training")
    pds.add_argument("--steps", type=int, default=200)
    pds.add_argument("--batch", type=int, default=16)
    pds.add_argument("--out", default="")
    pds.set_defaults(fn=cmd_train_deepstab)

    pp = sub.add_parser("profile", help="capture a jax.profiler trace")
    pp.add_argument("--logdir", default="/tmp/vstab_trace")
    pp.add_argument("--frames", type=int, default=30)
    pp.add_argument("--width", type=int, default=1920)
    pp.add_argument("--height", type=int, default=1080)
    pp.set_defaults(fn=cmd_profile)

    args = p.parse_args(argv)
    if args.fn is not cmd_bench:        # bench.main makes both calls itself
        from video_stab_tpu.utils.cache import enable_compilation_cache
        from video_stab_tpu.utils.device import require_gpu

        enable_compilation_cache()
        require_gpu()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
