"""Streaming integration tests with fake frame sources — no network, no
hardware (SURVEY.md §4c), plus config/control-plane tests."""

import dataclasses
import json
import os
import socket
import tempfile
import time
import urllib.request

import numpy as np
import pytest

from video_stab_tpu.io.channels import StreamGraph
from video_stab_tpu.io.control import (
    ConfigRestServer,
    TcpReceiver,
    apply_rest_update,
)
from video_stab_tpu.io.sinks import (
    MJPEGServer,
    NullSink,
    bitrate_bps_app,
    bitrate_kbps_server,
)
from video_stab_tpu.io.sources import SourceParams, SyntheticSource
from video_stab_tpu.utils.config import (
    AppConfig,
    load_config,
    parse_config_text,
    save_config,
)

REFERENCE_CONFIG = os.path.join(os.path.dirname(__file__), "fixtures",
                                "reference_config.yaml")


class TestSources:
    def test_synthetic_reads(self):
        src = SyntheticSource(SourceParams(source="s"), height=32, width=40,
                              n_frames=5).start()
        frames = [src.read(timeout=1.0) for _ in range(5)]
        src.stop()
        assert all(f is not None and f.shape == (32, 40, 3) for f in frames)

    def test_fault_injection_and_reconnect(self):
        # 3 good frames, then 12 failures (> MAX_CONSECUTIVE_FAILURES=5
        # twice over) trip the reconnect supervisor, then recovery.
        src = SyntheticSource(SourceParams(source="s"), height=16, width=20,
                              n_frames=0, fail_after=3, fail_count=12).start()
        got = 0
        deadline = time.monotonic() + 8.0
        while got < 6 and time.monotonic() < deadline:
            if src.read(timeout=0.5) is not None:
                got += 1
        stats = src.stats
        src.stop()
        assert got >= 6, (got, stats)
        assert stats["reconnects"] >= 1, stats

    def test_bounded_queue_drops(self):
        src = SyntheticSource(SourceParams(source="s", queue_size=2),
                              height=16, width=20, n_frames=50).start()
        time.sleep(1.0)          # producer outruns the absent consumer
        stats = src.stats
        src.stop()
        assert stats["frames_dropped"] > 0


class TestStreamGraph:
    def test_routing_and_hot_switch(self):
        g = StreamGraph()
        src = SyntheticSource(SourceParams(source="s"), height=16, width=20,
                              n_frames=0)
        sink = NullSink()
        seen = {"processed": 0}

        def proc(frame):
            seen["processed"] += 1
            return frame * 0  # black frames mark the processed path

        g.add_pipeline("source", source=src.start(), publish_to="source")
        g.add_pipeline("processing", listen_to="source", processor=proc,
                       publish_to="processed")
        out = g.add_pipeline("output", listen_to="processed", sink=sink)
        g.start()
        time.sleep(0.5)
        assert sink.count > 0 and seen["processed"] > 0
        # hot switch to passthrough
        g.set_listen_to("output", "source")
        assert out.listen_to == "source"
        c0 = sink.count
        time.sleep(0.3)
        assert sink.count > c0
        names = [p["name"] for p in g.pipeline_list()]
        assert names == ["source", "processing", "output"]
        g.stop()

    def test_switch_delivers_units_published_during_handover(self):
        """A unit published to the NEW channel between set_listen_to and
        the worker thread noticing the switch must be delivered — in the
        packet graph that unit is the fresh re-encode branch's SPS/PPS+IDR
        and skipping it makes a whole GOP undecodable downstream. The
        setter captures the join cursor at call time."""
        g = StreamGraph()
        got = []

        class ListSink:
            def write(self, item):
                got.append(item)

            def close(self):
                pass

        g.channel("a")
        g.channel("b")
        out = g.add_pipeline("output", listen_to="a", sink=ListSink())
        g.start()
        time.sleep(0.3)       # worker blocked in subscribe("a") — nothing
        g.set_listen_to("output", "b")     # captures b's head (seq 0) now
        g.channel("b").publish("idr-unit")  # lands before the worker wakes
        deadline = time.time() + 3.0
        while not got and time.time() < deadline:
            time.sleep(0.02)
        g.stop()
        assert got == ["idr-unit"]


class TestControl:
    def test_tcp_receiver(self):
        tcp = TcpReceiver(15733).start()
        s = socket.create_connection(("127.0.0.1", 15733))
        s.sendall(b"10 20\n30 40\n")
        time.sleep(0.3)
        assert tcp.try_get_latest() == (30, 40)
        assert tcp.try_get_latest() is None    # atomic exchange
        s.close()
        tcp.stop()

    def test_rest_update_and_backup(self, tmp_path):
        path = str(tmp_path / "c.yaml")
        save_config(AppConfig(), path)
        res = apply_rest_update(path, {"smoothingRadius": 21,
                                       "gamma": 0.8, "nope": 1})
        assert res["applied"] == {"smoothingRadius": 21, "gamma": 0.8}
        assert "nope" in res["ignored"]
        assert os.path.exists(path + ".backup")
        cfg = load_config(path)
        assert cfg.stabilizer.smoothing_radius == 21
        assert abs(cfg.enhancer.gamma - 0.8) < 1e-6

    def test_rest_server_endpoints(self, tmp_path):
        path = str(tmp_path / "c.yaml")
        save_config(AppConfig(), path)
        srv = ConfigRestServer(path, port=15734).start()
        try:
            health = json.load(urllib.request.urlopen(
                "http://127.0.0.1:15734/health"))
            assert health == {"status": "healthy"}
            req = urllib.request.Request(
                "http://127.0.0.1:15734/stabilization",
                data=json.dumps({"horizonLock": True}).encode())
            resp = json.load(urllib.request.urlopen(req))
            assert resp["status"] == "ok"
            assert load_config(path).stabilizer.horizon_lock is True
        finally:
            srv.stop()


class TestConfig:
    def test_parses_reference_config_verbatim(self):
        cfg = load_config(REFERENCE_CONFIG)
        assert cfg.video_source.startswith("rtsp://")
        s = cfg.stabilizer
        assert s.smoothing_radius == 15
        assert s.smoothing_method == "gaussian"   # the "gausian" typo mapped
        assert s.border_type == "reflect_101"
        assert s.crop_n_zoom is True
        assert s.roi == (192, 108, 1536, 864)
        assert s.feature_detector == "gftt"
        assert s.jitter_frequency == "adaptive"   # enum-int 3
        assert abs(s.fade_alpha - 0.9) < 1e-6      # camelCase fadeAlpha
        assert s.hf_freeze_duration == 30
        assert cfg.mode.tracker_enabled is True
        assert cfg.mode.stabilizer_enabled is False
        assert abs(cfg.enhancer.gamma - 1.2) < 1e-6
        assert cfg.roll_correction.angle_filter_max == 70.0
        assert cfg.tracker.processing_width == 960
        assert abs(cfg.tracker.confidence_threshold - 0.1) < 1e-6

    def test_roundtrip(self, tmp_path):
        cfg = load_config(REFERENCE_CONFIG)
        path = str(tmp_path / "c.yaml")
        save_config(cfg, path)
        cfg2 = load_config(path)
        assert cfg2.stabilizer == cfg.stabilizer
        assert cfg2.enhancer == cfg.enhancer
        assert cfg2.mode == cfg.mode

    def test_header_is_filestorage_dialect(self, tmp_path):
        path = str(tmp_path / "c.yaml")
        save_config(AppConfig(), path)
        assert open(path).readline().strip() == "%YAML:1.0"

    def test_unknown_keys_ignored(self):
        cfg = parse_config_text(
            "stabilizer:\n  smoothing_radius: 9\n  what_is_this: 3\n")
        assert cfg.stabilizer.smoothing_radius == 9


class TestSinks:
    def test_bitrate_heuristics(self):
        assert bitrate_kbps_server(1920, 1080, 30) == \
            max(2000, int(1920 * 1080 * 30 / 500))
        assert bitrate_bps_app(640, 360, 30) == 2_000_000      # clamped low
        assert bitrate_bps_app(3840, 2160, 60) == 8_000_000    # clamped high

    def test_mjpeg_server_serves_frames(self):
        srv = MJPEGServer(port=18554).start()
        try:
            srv.push_frame(np.full((32, 40, 3), 128, np.uint8))
            req = urllib.request.urlopen(srv.url, timeout=2.0)
            # read a bit of the multipart stream in a thread-safe way
            data = req.read(200)
            assert b"vstabframe" in data and b"image/jpeg" in data
        finally:
            srv.close()


class TestNative:
    @pytest.fixture(autouse=True)
    def _skip_without_lib(self):
        from video_stab_tpu import native
        if not native.available():
            pytest.skip("native toolchain unavailable")

    def test_frame_ring_drop_oldest(self):
        from video_stab_tpu import native
        ring = native.FrameRing((8, 8, 3), capacity=3)
        for i in range(5):
            ring.push(np.full((8, 8, 3), i, np.uint8), stamp=i)
        assert len(ring) == 3
        frame, stamp = ring.pop()
        assert stamp == 2 and frame[0, 0, 0] == 2   # oldest two dropped
        assert ring.stats["dropped"] == 2
        ring.close()

    def test_pacing_clock(self):
        from video_stab_tpu import native
        pc = native.PacingClock(200.0)
        t0 = time.perf_counter()
        for _ in range(10):
            pc.wait()
        dt = time.perf_counter() - t0
        assert 0.03 < dt < 0.3
        pc.close()

    def test_native_tcp(self):
        from video_stab_tpu import native
        tcp = native.NativeTcpReceiver(15735)
        s = socket.create_connection(("127.0.0.1", 15735))
        s.sendall(b"5 6\n")
        time.sleep(0.3)
        assert tcp.try_get_latest() == (5, 6)
        assert tcp.try_get_latest() is None
        s.close()
        tcp.stop()

    def test_load_failure_is_cached(self, monkeypatch):
        """On a toolchain-less host a failed build must be remembered —
        otherwise every available() probe re-spawns `make` with its 120 s
        timeout (io/codec.py's loader already does this; parity here)."""
        from video_stab_tpu import native

        calls = {"n": 0}

        def failing_build():
            calls["n"] += 1
            return False

        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "_load_failed", False)
        monkeypatch.setattr(native, "_LIB_PATH", "/nonexistent/lib.so")
        monkeypatch.setattr(native, "_build", failing_build)
        assert native.available() is False
        assert native.available() is False
        assert calls["n"] == 1          # second probe hits the cache
        # monkeypatch restores _lib/_load_failed/_LIB_PATH for later tests


class TestChannelBridge:
    def test_bidirectional(self):
        from video_stab_tpu.io.channels import ChannelBridge
        g = StreamGraph()
        br = ChannelBridge(g, "a", "b")
        g.channel("a").publish(np.ones((4, 4, 3), np.uint8))
        f = br.read(timeout=0.5)
        assert f is not None
        br.push_frame(f * 3)
        out, _ = g.channel("b").subscribe(0, timeout=0.5)
        assert out[0, 0, 0] == 3
        assert br.frames_in == 1 and br.frames_out == 1
        assert br.is_healthy()
        br.stop()

    def test_listen_to_switch_joins_live(self):
        """Hot listen-to re-point must join the NEW channel at its current
        head: sequence numbers are per channel, so a carried-over cursor
        either stalls (new channel behind the old one's count) or replays
        the retained ring (ahead). The interpipe semantic is live join
        (GstdManager.cpp:324-327)."""
        import time as _t

        from video_stab_tpu.io.channels import StreamGraph
        g = StreamGraph()
        got = []

        class _Sink:
            def write(self, item):
                got.append(item)

            def close(self):
                pass

        g.channel("a").depth = 256
        g.channel("b").depth = 256
        # Channel a far AHEAD of b in sequence count before the pipeline
        # ever runs; b pre-loaded with stale history that must NOT replay.
        for i in range(50):
            g.channel("a").publish(("a", i))
        for i in range(5):
            g.channel("b").publish(("b-stale", i))
        p = g.add_pipeline("out", listen_to="a", sink=_Sink())
        p.start()
        deadline = _t.time() + 5
        while len(got) < 50 and _t.time() < deadline:
            _t.sleep(0.01)
        assert len(got) == 50                 # startup replays retained a
        p.listen_to = "b"
        # the switch lands once the in-flight subscribe (0.5 s timeout)
        # returns; join-live skips items published before that
        _t.sleep(0.8)
        n_before = len(got)
        for i in range(7):
            g.channel("b").publish(("b-live", i))
        deadline = _t.time() + 5
        while len(got) < n_before + 7 and _t.time() < deadline:
            _t.sleep(0.01)
        p.stop()
        post = got[n_before:]
        assert post == [("b-live", i) for i in range(7)], post[:10]


@pytest.mark.slow
class TestGraphDaemon:
    def test_daemon_lifecycle_and_switch(self):
        from video_stab_tpu.io.daemon import GraphDaemonClient
        d = GraphDaemonClient(source="synthetic:64x48", output="null",
                              port=15918)
        try:
            assert d.initialize()
            assert d.create_pipelines()
            assert d.start()
            time.sleep(0.8)
            names = {p["name"]: p for p in d.pipeline_list()}
            assert set(names) == {"capture", "passthrough", "output"}
            assert names["capture"]["frames_processed"] > 0
            assert d.switch_mode(processing=True)
            assert d.pipeline_list()[-1]["listen_to"] == "processed"
            assert d.is_healthy()
        finally:
            d.stop()
        assert not d.is_healthy()


@pytest.mark.slow
class TestRemoteFrameRouting:
    def test_fan_in_two_streams(self):
        from video_stab_tpu.io.remote import RemoteFrameServer, RemoteFrameSink
        srv = RemoteFrameServer(port=15940).start()
        try:
            s0 = RemoteFrameSink("127.0.0.1", 15940, stream_id=0)
            s1 = RemoteFrameSink("127.0.0.1", 15940, stream_id=1)
            f0 = np.full((32, 40, 3), 50, np.uint8)
            f1 = np.full((32, 40, 3), 200, np.uint8)
            for _ in range(3):
                s0.write(f0)
                s1.write(f1)
            batch = srv.read_batch([0, 1], timeout=3.0)
            assert batch is not None and batch.shape == (2, 32, 40, 3)
            # JPEG round-trip keeps flat frames near their value
            assert abs(int(batch[0].mean()) - 50) < 5
            assert abs(int(batch[1].mean()) - 200) < 5
            # stalled stream repeats its last frame
            s0.write(f0)
            batch2 = srv.read_batch([0, 1], timeout=0.3)
            assert batch2 is not None
            s0.close(); s1.close()
        finally:
            srv.stop()


@pytest.mark.slow
class TestAppWithTracker:
    def test_fused_app_with_tracker_smoke(self, tmp_path):
        import dataclasses
        from video_stab_tpu.core.params import ModeParams, StabilizerParams
        from video_stab_tpu.io.runner import StabilizerApp
        from video_stab_tpu.models.tracker import TrackerParams
        from video_stab_tpu.io.sinks import NullSink

        cfg = AppConfig(
            video_source="synthetic:128x96",
            mode=ModeParams(stabilizer_enabled=True, tracker_enabled=True),
            stabilizer=StabilizerParams(
                smoothing_radius=5, analysis_width=128, analysis_height=96,
                max_corners=32, ransac_hypotheses=32),
            tracker=TrackerParams(processing_width=96, processing_height=64,
                                  confidence_threshold=0.99))
        sink = NullSink()
        app = StabilizerApp(cfg, sink=sink)
        app.start()
        deadline = time.monotonic() + 120.0   # first compile dominates
        while sink.count < 3 and time.monotonic() < deadline:
            time.sleep(0.5)
        app.stop()
        assert sink.count >= 3, sink.count


class TestKeyboardControls:
    def test_dispatch(self):
        """Keyboard map mirrors vsg.cpp:1426-1451: p/r/s/q + ESC."""
        from video_stab_tpu.io.control import KeyboardController
        hits = []
        kc = KeyboardController(lambda: hits.append("p"),
                                lambda: hits.append("r"),
                                lambda: hits.append("s"),
                                lambda: hits.append("q"))
        for k in ["p", "r", "s", "q", "\x1b", "x"]:
            kc.handle_key(k)
        assert hits == ["p", "r", "s", "q", "q"]

    def test_app_mode_switch_via_keys(self, tmp_path):
        """p/r re-point the output pipeline's listen-to channel — the
        seamless switch (GstdManager.cpp:324-327)."""
        import dataclasses

        from video_stab_tpu.core.params import ModeParams
        from video_stab_tpu.io.runner import StabilizerApp
        from video_stab_tpu.utils.config import AppConfig
        cfg = dataclasses.replace(
            AppConfig(), video_source="synthetic:64x48",
            mode=ModeParams(enhancer_enabled=True))
        app = StabilizerApp(cfg, sink=None, fused=False)
        assert app.graph.pipeline("output").listen_to == "processed"
        app.switch_passthrough()
        assert app.graph.pipeline("output").listen_to == "source"
        app.switch_processing()
        assert app.graph.pipeline("output").listen_to == "processed"


@pytest.mark.slow
class TestLosslessChannel:
    """Channel depth>1: lossless in-order delivery (packet channels must
    not drop access units — P-frames reference their predecessors)."""

    def test_in_order_no_drops(self):
        from video_stab_tpu.io.channels import Channel
        ch = Channel("pkt", depth=64)
        for i in range(50):
            ch.publish(i)
        seq = 0
        got = []
        while True:
            item, seq2 = ch.subscribe(seq, timeout=0.01)
            if item is None:
                break
            got.append(item)
            seq = seq2
        assert got == list(range(50))

    def test_latest_only_default(self):
        from video_stab_tpu.io.channels import Channel
        ch = Channel("frames")          # depth=1: freshness wins
        for i in range(10):
            ch.publish(i)
        item, _ = ch.subscribe(0, timeout=0.01)
        assert item == 9

    def test_overflow_skips_forward(self):
        from video_stab_tpu.io.channels import Channel
        ch = Channel("pkt", depth=4)
        for i in range(10):
            ch.publish(i)
        item, seq = ch.subscribe(0, timeout=0.01)
        assert item == 6                # oldest retained after overflow
        item, _ = ch.subscribe(seq, timeout=0.01)
        assert item == 7
