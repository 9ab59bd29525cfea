"""Serve N camera streams batched across the device mesh — the multi-camera
deployment (BASELINE.json config 5: "8x concurrent 1080p streams batched
across a device mesh"). Sources here are synthetic; swap open_source() targets
for real RTSP URLs.
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.join(_os.path.dirname(_os.path.abspath(__file__)),
                                  _os.pardir))   # run from a source checkout

import argparse
import time

import numpy as np

from video_stab_tpu.core.params import StabilizerParams
from video_stab_tpu.io.sources import SourceParams, SyntheticSource
from video_stab_tpu.parallel import MultiStreamStabilizer, make_stream_mesh


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--streams", type=int, default=8)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=360)
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--ingest-port", type=int, default=0,
                    help="listen for remote JPEG-over-TCP ingest senders "
                         "(io.remote.RemoteFrameSink) on this port instead "
                         "of reading local synthetic sources — the "
                         "multi-host DCN fan-in deployment")
    args = ap.parse_args()

    if args.ingest_port:
        serve_remote(args)
        return

    mesh = make_stream_mesh()
    print(f"mesh: {mesh.shape} over {len(mesh.devices.flat)} devices")
    params = StabilizerParams(smoothing_radius=10,
                              analysis_width=min(args.width, 960),
                              analysis_height=min(args.height, 540))
    ms = MultiStreamStabilizer(params, n_streams=args.streams, mesh=mesh)

    sources = [
        SyntheticSource(SourceParams(source=f"cam{i}",
                                     threaded_queue_mode=False),
                        height=args.height, width=args.width, seed=i).start()
        for i in range(args.streams)
    ]
    t0 = time.perf_counter()
    out_frames = 0
    for _ in range(args.frames):
        batch = np.stack([s.read() for s in sources])
        out = ms.stabilize_batch(batch)
        if out is not None:
            out_frames += out.shape[0]
    dt = time.perf_counter() - t0
    print(f"{out_frames} stabilized frames across {args.streams} streams "
          f"in {dt:.2f}s -> {out_frames / dt:.1f} frames/s aggregate")
    for s in sources:
        s.stop()


def serve_remote(args):
    """Serving-host main loop for multi-host ingest: decode happens on the
    INGEST hosts (each runs a RemoteFrameSink per camera); this host only
    assembles lockstep batches and runs one batched device dispatch per
    tick (DESIGN.md sec. 14 — one core of software decode feeds only ~1.4
    real-time 1080p30 streams, so the serving host does zero decode)."""
    from video_stab_tpu.io.remote import RemoteFrameServer
    from video_stab_tpu.parallel.multistream import serve_remote_streams

    mesh = make_stream_mesh()
    params = StabilizerParams(smoothing_radius=10,
                              analysis_width=min(args.width, 960),
                              analysis_height=min(args.height, 540))
    ms = MultiStreamStabilizer(params, n_streams=args.streams, mesh=mesh)
    srv = RemoteFrameServer(port=args.ingest_port).start()
    print(f"ingest fan-in listening on :{args.ingest_port}; waiting for "
          f"{args.streams} senders (stream_id 0..{args.streams - 1})")
    counts = {}

    def on_output(sid, frame):
        counts[sid] = counts.get(sid, 0) + 1

    t0 = time.perf_counter()
    stats = serve_remote_streams(srv, ms, list(range(args.streams)),
                                 n_ticks=args.frames, on_output=on_output)
    dt = time.perf_counter() - t0
    total = int(sum(stats["emitted"]))
    print(f"{total} stabilized frames across {args.streams} remote streams "
          f"in {dt:.2f}s -> {total / dt:.1f} frames/s aggregate "
          f"(stalled ticks: {stats['stalled_ticks']})")
    srv.stop()


if __name__ == "__main__":
    main()
