"""Multi-stream batched serving over a device mesh.

The reference serves one stream per process (hidden static state forbids
more — SURVEY.md §5 'race detection'). Here the stabilizer step is a pure
function over an explicit state pytree, so N independent streams batch as a
leading axis and shard across devices:

    mesh     = Mesh(devices, ("stream",))
    states   = batched state pytree, sharded P("stream")
    frames   -> (N, H, W, 3) uint8, sharded P("stream")
    step     = jit(vmap(analyze_fn))  — XLA partitions the batch over the
               devices with no collectives (streams are independent; this is the
               'embarrassingly parallel' end of the sharding spectrum, which
               is exactly what multi-camera serving wants: zero cross-chip
               traffic in steady state).

Reference counterpart: one Stabilizer instance per camera + gstd
process-level dataflow (SURVEY.md §2 'Parallelism & communication
inventory'); BASELINE.json config 5 ("8x concurrent 1080p streams batched
across a device mesh").
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from video_stab_tpu.core.params import StabilizerParams
from video_stab_tpu.core.state import StabilizerState, stabilizer_state_init
from video_stab_tpu.core.stabilizer import (
    stabilizer_emit_gated_fn,
    stabilizer_init_step_fn,
    stabilizer_step_metrics_fn,
)


def make_stream_mesh(devices: Optional[Sequence] = None,
                     axis_name: str = "stream") -> Mesh:
    """1-D mesh over all (or the given) devices for stream-axis sharding."""
    devices = list(devices) if devices is not None else jax.devices()
    return Mesh(np.array(devices), (axis_name,))


def batched_state_init(params: StabilizerParams, n_streams: int,
                       height: int, width: int,
                       mesh: Optional[Mesh] = None) -> StabilizerState:
    """Stacked state for n_streams, with per-stream PRNG seeds, placed with
    stream-axis sharding when a mesh is given."""
    deepstab = ()
    if params.deep_stabilization:
        # Resolve the learned-estimator weights once and replicate across
        # the stream axis (streams share the model; vmap expects a leading
        # batch dim on every state leaf). The single-stream wrapper does
        # the same via Stabilizer._ensure_state.
        from video_stab_tpu.models.deepstab import resolve_deepstab_weights
        deepstab = resolve_deepstab_weights(params)
    states = [
        stabilizer_state_init(
            dataclasses.replace(params, seed=params.seed + i), height, width
        )._replace(deepstab=deepstab)
        for i in range(n_streams)
    ]
    batched = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *states)
    if mesh is None:
        return jax.device_put(batched, jax.devices()[0])
    sharding = NamedSharding(mesh, P(mesh.axis_names[0]))
    return jax.tree_util.tree_map(
        lambda x: jax.device_put(
            x, sharding if x.ndim >= 1 and x.shape[0] == n_streams
            else NamedSharding(mesh, P())),
        batched)


class MultiStreamStabilizer:
    """Batch-of-streams stabilizer: push (N, H, W, 3) uint8, get (N, ...)
    stabilized frames after the shared look-ahead warm-up.

    All N streams advance in lockstep (the multi-camera serving model: one
    synchronized grab per camera per tick). Per-stream reconnect/
    drop-outs are handled upstream by the host IO supervisor
    (video_stab_tpu.io) which re-feeds the last frame for a stalled stream.
    """

    def __init__(self, params: StabilizerParams, n_streams: int,
                 mesh: Optional[Mesh] = None):
        if params.gftt_topk == "auto":
            # vmap lowers batched-predicate lax.conds (the GFTT fallback
            # guards) to both-branches + select; pick the single-branch
            # "staged" variant here — two-stage candidate extraction with
            # no cond anywhere (ops/features.py). The emit warp needs no
            # such choice: the gather warp has no branches.
            import dataclasses
            params = dataclasses.replace(params, gftt_topk="staged")
        self.params = params
        self.n_streams = n_streams
        self.mesh = mesh
        self._state: Optional[StabilizerState] = None
        self._shape: Optional[tuple] = None
        # Host-side per-stream mirrors of (n_frames, emit_idx): the in-graph
        # warm-up gate holds the device cursors to exactly these values, so
        # steady state needs ONE dispatch and ZERO device->host syncs per
        # batch tick — and per-stream warm-up (after reset_stream) is still
        # tracked exactly.
        self._frames_in = np.zeros(n_streams, np.int64)
        self._emitted = np.zeros(n_streams, np.int64)
        p = params

        self._init_b = jax.jit(
            jax.vmap(functools.partial(stabilizer_init_step_fn, p)),
            donate_argnums=0)
        self._step_b = jax.jit(
            # redetect_tick rides UNBATCHED (in_axes None): the shared
            # step counter keeps the redetect lax.cond's predicate scalar
            # — a batched predicate would run GFTT every frame for every
            # stream (vmap lowers batched conds to both-branches+select).
            jax.vmap(functools.partial(stabilizer_step_metrics_fn, p),
                     in_axes=(0, 0, None)),
            donate_argnums=0)
        self._emit_b = jax.jit(
            jax.vmap(functools.partial(stabilizer_emit_gated_fn, p)),
            donate_argnums=0)
        self.last_valid: Optional[np.ndarray] = None
        self.last_metrics: dict = {}

    def _ensure_state(self, frames: np.ndarray) -> None:
        n, h, w = frames.shape[:3]
        if n != self.n_streams:
            raise ValueError(f"expected {self.n_streams} streams, got {n}")
        if self._state is None:
            self._state = batched_state_init(self.params, n, h, w, self.mesh)
            self._shape = (h, w)
        elif self._shape != (h, w):
            raise ValueError("frame size changed; call clean()")

    def _put(self, frames: np.ndarray):
        if self.mesh is not None:
            sharding = NamedSharding(self.mesh, P(self.mesh.axis_names[0]))
            return jax.device_put(frames, sharding)
        return jnp.asarray(frames)

    def stabilize_batch(self, frames) -> Optional[np.ndarray]:
        """frames: (N, H, W, 3) uint8. Returns (N, H', W', 3) uint8 or None
        during warm-up. One combined analyze+emit dispatch per tick;
        per-stream readiness comes from the host counters (no sync)."""
        frames = np.ascontiguousarray(frames, dtype=np.uint8)
        self._ensure_state(frames)
        fdev = self._put(frames)
        if not self._frames_in.any():
            self._state = self._init_b(self._state, fdev)
            self._frames_in[:] = 1
            return None
        self._state, out, _ready, self.last_metrics = self._step_b(
            self._state, fdev,
            jnp.int32(int(self._frames_in.max())))
        self._frames_in += 1
        ready = (self._frames_in - self._emitted) >= \
            self.params.effective_radius
        self._emitted += ready
        self.last_valid = ready
        self.last_out_device = out      # sharded device array (placement
        if not ready.any():             # introspection: addressable_shards)
            return None       # whole batch still warming up
        return np.asarray(out)

    def flush_batch(self) -> Optional[np.ndarray]:
        """Drain: the in-graph gate only releases streams whose queue still
        holds >= effective_radius frames, so flush stops there (per-stream;
        single-stream full drain is Stabilizer.flush)."""
        if self._state is None:
            return None
        ready = (self._frames_in - self._emitted) >= \
            self.params.effective_radius
        if not ready.any():
            return None
        self._state, out, _r = self._emit_b(self._state)
        self._emitted += ready
        self.last_valid = ready
        return np.asarray(out)

    def reset_stream(self, i: int) -> None:
        """Recycle slot i for a new stream (camera reconnect / swap): its
        state slice is re-initialized; the other streams are untouched. The
        fresh stream re-warms its own look-ahead implicitly (its queue
        indices restart while the batch keeps stepping)."""
        if self._state is None:
            return
        h, w = self._shape
        fresh = stabilizer_state_init(
            dataclasses.replace(self.params, seed=self.params.seed + i),
            h, w)
        if self.params.deep_stabilization:
            # Match the batched tree structure (weights leaves present) —
            # the shared model is re-resolved; resets are rare host events.
            from video_stab_tpu.models.deepstab import (
                resolve_deepstab_weights,
            )
            fresh = fresh._replace(
                deepstab=resolve_deepstab_weights(self.params))

        def put(batched, leaf):
            return batched.at[i].set(leaf)

        self._state = jax.tree_util.tree_map(put, self._state, fresh)
        self._frames_in[i] = 0
        self._emitted[i] = 0

    def clean(self) -> None:
        self._state = None
        self._shape = None
        self._frames_in[:] = 0
        self._emitted[:] = 0


def serve_remote_streams(server, stabilizer: "MultiStreamStabilizer",
                         stream_ids: Sequence[int], n_ticks: int,
                         on_output=None, read_timeout: float = 2.0) -> dict:
    """Couple a DCN ingest fan-in (io.remote.RemoteFrameServer) to the
    batched device step — the serving-host main loop (VERDICT r4 #8).

    Each tick: ``server.read_batch(stream_ids)`` assembles the lockstep
    (N, H, W, 3) batch (stalled streams repeat their last frame — the
    CamCap last-frame semantics over the network, CamCap.cpp:141-256),
    one ``stabilize_batch`` dispatch advances all N streams, and
    ``on_output(stream_id, frame)`` fires for every stream the warm-up
    gate has released (``stabilizer.last_valid``).

    Returns counters: {"ticks", "emitted" (per-stream np array),
    "stalled_ticks" (read_batch timeouts before every stream fed)}.
    """
    ids = list(stream_ids)
    emitted = np.zeros(len(ids), np.int64)
    stalled = 0
    ticks = 0
    while ticks < n_ticks:
        batch = server.read_batch(ids, timeout=read_timeout)
        if batch is None:              # not every stream has fed yet
            stalled += 1
            if stalled > n_ticks + 100:
                break
            continue
        out = stabilizer.stabilize_batch(batch)
        ticks += 1
        if out is None:
            continue
        valid = stabilizer.last_valid
        for k, sid in enumerate(ids):
            if valid is not None and valid[k]:
                emitted[k] += 1
                if on_output is not None:
                    on_output(sid, out[k])
    return {"ticks": ticks, "emitted": emitted, "stalled_ticks": stalled}
