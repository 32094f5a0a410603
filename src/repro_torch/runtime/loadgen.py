"""Open-loop load generator + SLO harness over the real serving stack.

The bench clients in `engine.run_streaming` are a closed loop: N always-on
sessions, each sending its next request the instant the last reply lands.
Production traffic is open-loop — arrivals do not slow down because the
server is slow — which is exactly the regime where queueing delay diverges
and an SLO means something. This module simulates that regime at scale
against the *real* stack: every request is a real `core.wire` frame (CRC,
subheaders, byte accounting) crossing a real `transport` channel into the
real `StreamingServer` (arena slots, per-(meta, bucket) staging, fused
decode+step, ARQ dedup), with real bottom/top model steps producing real
tokens — on the card, the client's codec is one launch of the fused
encode kernel per served token (`protocol.client_encode_device`) and the
server decodes each meta group of a flush with one `decode_to_slots`
launch. Only *time* is simulated.

Co-simulation design: one `testing.clock.VirtualClock` plus a single-
threaded event loop (a heap of (time, seq, fn)) replaces every thread in
the threaded engine:

  * reader threads  -> `server.pump` events, fired when a frame's
    transmission delay (client bandwidth cap) elapses;
  * the serve loop  -> flush events scheduled exactly at
    `BatchingQueue.next_flush_at`, serialized by a modeled service time
    (`ServiceModel`: per-flush overhead + per-row + per-wire-byte — the
    per-byte term is what makes shedding bytes relieve congestion);
  * client threads  -> per-session send/reply/retry events driving the
    same `ArqClientMixin` machinery (`_accept_reply`/`_retransmit`/
    `_reconnect`) the blocking client runs, so chaos from
    `testing.faults.FaultInjector` is recovered by the same code paths.

Everything — arrivals (Poisson or 2-state MMPP bursts), session shapes,
compressor fleet assignment, fault draws, retry timing — is a
deterministic function of the seed: two runs produce bit-identical arrival
traces, (k, bits) trajectories, and SLO reports. The draws are the
reference's `random.Random` formulas and time is virtual, so the port's
report equals the reference's field for field but `wall_s_real`
(`tests/test_torch_loadgen.py`, clean, QoS and under chaos). The report's
latency percentiles are VIRTUAL time from the `ServiceModel`, never a
measured card time; `wall_s_real` is the host's wall clock of the loop.

Closing the loop, each session may carry a `runtime.qos.QoSController`
that observes queue depth and token latency per reply and walks the
session's compressor down a (k, bits) ladder under congestion.

Beyond the reference's report, `served` holds what the port's kernels
saw: each session's generated tokens, the server's decode launches by
payload kind (one per meta group of a flush) and its mixed-meta flushes.
"""
from __future__ import annotations

import dataclasses
import functools
import heapq
import random
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import compressors, wire
from repro_torch.core.payload import to_host
from repro_torch.models import transformer
from repro_torch.models.config import ArchConfig
from repro_torch.obs.export import write_trace
from repro_torch.obs.registry import MetricsRegistry
from repro_torch.obs.trace import (EVT_ADMISSION_REJECT, NULL_TRACER,
                                   SERVE_TID, SPAN_CLIENT_ENCODE,
                                   SPAN_WIRE_SEND, Tracer, session_tid)
from repro_torch.runtime import engine as _engine
from repro_torch.runtime import steps
from repro_torch.runtime.arq import ArqClientMixin
from repro_torch.runtime.client import encode_frame
from repro_torch.runtime.metrics import LatencyStats
from repro_torch.runtime.qos import QoSController, QoSSpec
from repro_torch.runtime.qos import compressor_spec as qos_compressor_spec
from repro_torch.runtime.server import StreamingServer
from repro_torch.runtime.session import SessionStats
from repro_torch.runtime.transport import channel_pair
from repro_torch.testing.clock import VirtualClock

_EPS = 1e-9

# trace track for the modeled service time (`ServiceModel.flush_s`): its
# spans cover [flush, server_free_at] and may abut the next flush exactly,
# so they get their own track rather than riding the serve loop's
_SERVICE_TID = 2_000_000


# -- config surface ----------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ArrivalSpec:
    """Open-loop session arrival process.

    `poisson`: exponential inter-arrivals at `rate` sessions/s.
    `mmpp`: 2-state Markov-modulated Poisson — calm periods at `rate`
    alternate with bursts at `burst_rate` (default 2x), with exponential
    dwell times `mean_calm_s` / `mean_burst_s`. The seeded state path is
    part of the report, so a bench can gate on behavior *during* bursts.
    """

    process: str = "poisson"            # "poisson" | "mmpp"
    rate: float = 20.0                  # sessions/s (calm state)
    burst_rate: float = 0.0             # sessions/s in bursts (0 -> 2*rate)
    mean_calm_s: float = 4.0
    mean_burst_s: float = 2.0

    def __post_init__(self):
        assert self.process in ("poisson", "mmpp")
        assert self.rate > 0


@dataclasses.dataclass(frozen=True)
class FleetSpec:
    """Heterogeneous client population: compressor mix, session shapes,
    think times, and the client-side uplink/downlink bandwidth cap."""

    compressors: Tuple[str, ...] = ("randtopk:k=16",)
    weights: Optional[Tuple[float, ...]] = None     # sampling weights
    prompt_len: Tuple[int, int] = (2, 4)            # inclusive range
    gen: Tuple[int, int] = (4, 8)                   # inclusive range
    think_s: float = 0.0        # mean exponential think time between steps
    bandwidth_Bps: float = 0.0  # per-client link bytes/s (0 = infinite)


@dataclasses.dataclass(frozen=True)
class ServiceModel:
    """Virtual-time cost of one server flush: overhead + per-row compute +
    per-wire-byte host staging/decode. The per-byte term carries the
    operational claim under test — compressed frames are cheaper to serve,
    so tightening (k, bits) genuinely raises capacity. Virtual seconds, not
    a measurement of any device."""

    flush_overhead_s: float = 1e-3
    per_row_s: float = 2e-4
    per_byte_s: float = 2e-5

    def flush_s(self, rows: int, wire_bytes: int) -> float:
        return (self.flush_overhead_s + self.per_row_s * rows
                + self.per_byte_s * wire_bytes)


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """Declared service-level objectives the report is graded against."""

    p99_ms: float = 250.0               # token-latency p99 ceiling
    p50_ms: float = 0.0                 # optional p50 ceiling (0 = off)
    max_reject_frac: float = 0.0        # admission rejections / arrivals
    max_queue_depth: int = 0            # optional depth ceiling (0 = off)


@dataclasses.dataclass(frozen=True)
class LoadGenConfig:
    """One traffic scenario; everything downstream derives from `seed`."""

    seed: int = 0
    duration_s: float = 20.0            # arrivals stop here; drain continues
    arrivals: ArrivalSpec = ArrivalSpec()
    fleet: FleetSpec = FleetSpec()
    service: ServiceModel = ServiceModel()
    slo: SLOSpec = SLOSpec()
    qos: Optional[QoSSpec] = None       # None -> static fleet
    capacity: int = 32                  # arena slots = concurrent sessions
    max_batch: int = 8
    max_wait: float = 0.005
    admission_depth: int = 64           # reject arrivals above this backlog
    retry_timeout: Optional[float] = 0.5
    max_retries: int = 64
    device_encode: bool = True          # device-packed wire frames (the
    #   `steps.make_bottom_step_device` path: one fused encode launch per
    #   served token on the card); frames are byte-identical to the host
    #   codec's, so seeded reports do not depend on this flag


# -- arrival process ---------------------------------------------------------

class _Arrivals:
    """Seeded arrival-time generator; `state_path` records MMPP flips."""

    def __init__(self, spec: ArrivalSpec, seed: int):
        self.spec = spec
        self._rng = random.Random(seed)
        self._burst = False
        self._switch_at = (self._rng.expovariate(1.0 / spec.mean_calm_s)
                           if spec.process == "mmpp" else float("inf"))
        self.state_path: List[Tuple[float, str]] = [(0.0, "calm")]

    def next_after(self, t: float) -> float:
        s = self.spec
        if s.process == "poisson":
            return t + self._rng.expovariate(s.rate)
        while True:
            rate = (s.burst_rate or 2 * s.rate) if self._burst else s.rate
            gap = self._rng.expovariate(rate)
            if t + gap < self._switch_at:
                return t + gap
            t = self._switch_at
            self._burst = not self._burst
            self.state_path.append((t, "burst" if self._burst else "calm"))
            mean = s.mean_burst_s if self._burst else s.mean_calm_s
            self._switch_at = t + self._rng.expovariate(1.0 / mean)


# -- per-session client state ------------------------------------------------

class _InFlight:
    """The one outstanding stop-and-wait request of a session."""

    __slots__ = ("step", "frame_bytes", "header_nbytes", "t_send",
                 "retries", "attempt")

    def __init__(self, step: int, frame_bytes: bytes, header_nbytes: int,
                 t_send: float):
        self.step = step
        self.frame_bytes = frame_bytes
        self.header_nbytes = header_nbytes
        self.t_send = t_send
        self.retries = 0        # replays spent (timeout- or error-triggered)
        self.attempt = 0        # bumped per (re)transmission: stale-timer guard


class _Conn:
    """One client<->server channel instance (reconnects make new ones)."""

    __slots__ = ("sep", "sid_seen", "retired")

    def __init__(self, sep):
        self.sep = sep          # server endpoint, pumped by the event loop
        self.sid_seen = None    # per-connection fault-attribution state
        self.retired = False


class _LoadSession(ArqClientMixin):
    """Event-driven feature owner: the `StreamingClient` request cycle with
    the blocking reply wait replaced by harness events. Reuses the ARQ
    mixin's reconnect/retransmit/reply-classification verbatim."""

    _reply_kind = wire.FRAME_TOKENS

    def __init__(self, sid: int, cache, prompt: np.ndarray, gen: int,
                 comp_spec: str, qos: Optional[QoSController],
                 think_rng: random.Random, think_s: float,
                 bandwidth_Bps: float, reconnect: Callable, clock):
        self.id = sid
        self.cache = cache
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.gen = gen
        self.comp_spec = comp_spec          # static fleet assignment
        self.qos = qos                      # adaptive override (may be None)
        self.think_rng = think_rng
        self.think_s = think_s
        self.bandwidth_Bps = bandwidth_Bps
        self.reconnect = reconnect          # () -> fresh client endpoint
        self.clock = clock
        self.endpoint = None                # set by the first reconnect()
        self.conn: Optional[_Conn] = None   # server half, set alongside
        self.stats = SessionStats()
        self.step = 0
        self.n_steps = len(self.prompt) + gen - 1
        self.inflight: Optional[_InFlight] = None
        self.finished = False
        self.failed: Optional[BaseException] = None
        self.slot_released = False
        self.generated: List[int] = []
        self.latencies: List[float] = []
        self.kb_trace: List[Tuple[int, int]] = []   # (k, bits) per step
        self.t_arrive = clock.monotonic()
        self.t_done = float("nan")

    # bound by the harness at admit (`bind_instruments`); None before that
    _m_frames_down = None
    _m_bytes_down = None

    def bind_instruments(self, registry) -> None:
        self._m_frames_down = registry.counter("frames_total",
                                               party="client",
                                               direction="down")
        self._m_bytes_down = registry.counter("wire_bytes_total",
                                              party="client",
                                              direction="down")

    def _count_reply(self, reply: wire.Frame) -> None:
        self.stats.count_down(reply.nbytes)
        if self._m_frames_down is not None:
            self._m_frames_down.inc()
            self._m_bytes_down.inc(reply.nbytes)

    def spec(self) -> str:
        return (self.qos.compressor_spec() if self.qos is not None
                else self.comp_spec)

    def tx_s(self, nbytes: int) -> float:
        """Link transmission delay under the client's bandwidth cap."""
        if self.bandwidth_Bps <= 0:
            return 0.0
        return nbytes / self.bandwidth_Bps

    def think(self) -> float:
        if self.think_s <= 0:
            return 0.0
        return self.think_rng.expovariate(1.0 / self.think_s)

    def next_token(self) -> np.ndarray:
        """The token the NEXT request carries (prompt prefill, then the
        last generated token) — same discipline as `StreamingClient`."""
        if self.step < len(self.prompt):
            return np.asarray([[self.prompt[self.step]]], np.int32)
        return np.asarray([[self.generated[-1]]], np.int32)


# -- the harness -------------------------------------------------------------

class _Harness:
    """Single-threaded virtual-time co-simulation of one traffic scenario."""

    def __init__(self, cfg: ArchConfig, lg: LoadGenConfig, params,
                 wrap_endpoint=None, trace: bool = False, device=None):
        self.cfg = cfg
        self.lg = lg
        self.wrap_endpoint = wrap_endpoint
        self.clock = VirtualClock()
        self.heap: List[Tuple[float, int, Callable]] = []
        self._seq = 0                   # heap tie-break: push order
        # per-run observability: a private registry (so two scenarios never
        # share counters) and, when tracing, a tracer on the VIRTUAL clock —
        # every stamp is simulated time, so the exported Chrome-trace JSON
        # is a deterministic function of the seed
        self.registry = MetricsRegistry()
        self.tracer = Tracer(clock=self.clock) if trace else NULL_TRACER

        dev = _engine.resolve_device(device)
        cut = (cfg.split.cut_layer if cfg.split and cfg.split.cut_layer > 0
               else max(1, cfg.n_layers // 2))
        assert 0 < cut < cfg.n_layers
        self.cut = cut
        # the kernels on the card unless the config asks for the plain
        # versions (`split.backend="torch"`)
        self.backend = cfg.split.backend if cfg.split else None
        if params is None:
            gen = torch.Generator(device=dev).manual_seed(lg.seed)
            params = transformer.init_model(cfg, gen, device=dev)
        self.params = params
        self.max_len = lg.fleet.prompt_len[1] + lg.fleet.gen[1]
        self._make_cache, make_top_cache = _engine.cache_makers(
            cfg, self.max_len, dev, params)
        self.server = StreamingServer(
            self.params, steps.make_arena_top_step(cfg, cut),
            make_top_cache, device=dev, max_batch=lg.max_batch,
            max_wait=lg.max_wait, dtype=cfg.adtype(), capacity=lg.capacity,
            x_shape=(1, 1, cfg.d_model), backend=self.backend,
            clock=self.clock, tracer=self.tracer, registry=self.registry)
        self._bottom_cache: Dict[str, Tuple] = {}   # spec -> (comp, step)

        # independent seeded streams so adding draws to one cannot shift
        # another (the reseed discipline of testing.faults)
        self.arrivals = _Arrivals(lg.arrivals, lg.seed * 7919 + 1)
        self._fleet_rng = random.Random(lg.seed * 7919 + 2)

        self.sessions: Dict[int, _LoadSession] = {}
        self.slots_in_use = 0
        self.server_free_at = 0.0
        self._flush_armed: Optional[float] = None
        self._next_sid = 0

        # metrics
        self.latency = LatencyStats()
        self.arrive_trace: List[float] = []
        self.rejects: List[Tuple[float, str]] = []
        self.depth_at_flush: List[int] = []
        self.completed = 0
        self.failed: List[int] = []
        self.t_end = 0.0
        # pre-bound client-side instruments (the server pre-binds its own)
        reg = self.registry
        self._m_cl_frames_up = reg.counter("frames_total", party="client",
                                           direction="up")
        self._m_cl_payload_up = reg.counter("payload_bytes_total",
                                            party="client", direction="up")
        self._m_cl_framing_up = reg.counter("framing_bytes_total",
                                            party="client", direction="up")
        self._m_cl_tokens = reg.counter("tokens_total", party="client")
        self._m_cl_latency = reg.histogram("token_latency_ms")
        self._m_reject = {
            reason: reg.counter("admission_rejects_total", reason=reason)
            for reason in ("capacity", "queue")}

    # -- event loop machinery ------------------------------------------------

    def _push(self, t: float, fn: Callable) -> None:
        self._seq += 1
        heapq.heappush(self.heap, (t, self._seq, fn))

    def run(self) -> dict:
        self._warm()
        t0 = time.perf_counter()
        first = self.arrivals.next_after(0.0)
        if first <= self.lg.duration_s:
            self._push(first, self._arrival_event)
        while self.heap:
            t, _, fn = heapq.heappop(self.heap)
            self.clock.advance_to(t)
            self.t_end = max(self.t_end, self.clock.monotonic())
            fn()
        return self._report(time.perf_counter() - t0)

    def _warm(self) -> None:
        """Run every bottom/decode/step path the scenario can reach (fleet
        specs + the whole QoS ladder) once before the virtual clock's first
        event — the kernel library's build and each path's first launch
        never land inside a session's wall time."""
        specs = list(self.lg.fleet.compressors)
        if self.lg.qos is not None:
            specs += [qos_compressor_spec(k, b)
                      for k, b in self.lg.qos.ladder()]
        tok0 = np.zeros((1, 1), np.int32)
        examples = []
        for spec in dict.fromkeys(specs):
            comp, fn = self._bottom(spec)
            out = fn(self.params, self._make_cache(), tok0)
            examples.append(to_host(out[0] if self.lg.device_encode
                                    else out))
        self.server.warm(examples)

    def _bottom(self, spec: str):
        """(compressor, bottom step) for one spec string, cached — the
        ladder is bounded, so is the cache."""
        hit = self._bottom_cache.get(spec)
        if hit is None:
            kw = {} if self.backend is None else {"backend": self.backend}
            comp = compressors.make_compressor(spec, **kw)
            make = (steps.make_bottom_step_device if self.lg.device_encode
                    else steps.make_bottom_step)
            hit = self._bottom_cache[spec] = (
                comp, make(self.cfg, self.cut, comp))
        return hit

    # -- arrivals & admission ------------------------------------------------

    def _arrival_event(self) -> None:
        now = self.clock.monotonic()
        self.arrive_trace.append(round(now, 9))
        lg = self.lg
        nxt = self.arrivals.next_after(now)
        if nxt <= lg.duration_s:
            self._push(nxt, self._arrival_event)
        # admission control: bounded concurrency (arena slots) and bounded
        # backlog — an open-loop overload otherwise grows the queue (and
        # every session's latency) without limit
        if self.slots_in_use >= lg.capacity:
            self._reject(now, "capacity")
            return
        if len(self.server.queue) >= lg.admission_depth:
            self._reject(now, "queue")
            return
        self._admit(now)

    def _reject(self, now: float, reason: str) -> None:
        self.rejects.append((round(now, 9), reason))
        self._m_reject[reason].inc()
        self.tracer.instant(EVT_ADMISSION_REJECT, tid=SERVE_TID,
                            reason=reason, slots=self.slots_in_use,
                            depth=len(self.server.queue))

    def _admit(self, now: float) -> None:
        lg, rng = self.lg, self._fleet_rng
        sid = self._next_sid
        self._next_sid += 1
        fleet = lg.fleet
        spec = rng.choices(list(fleet.compressors),
                           weights=fleet.weights)[0]
        plen = rng.randint(*fleet.prompt_len)
        gen = rng.randint(*fleet.gen)
        prompt = [rng.randrange(self.cfg.vocab) for _ in range(plen)]
        qos = (QoSController(lg.qos, tracer=self.tracer,
                             registry=self.registry, sid=sid)
               if lg.qos is not None else None)
        ls = _LoadSession(
            sid, self._make_cache(), np.asarray(prompt, np.int32), gen,
            spec, qos, random.Random(lg.seed * 7919 + 100 + sid),
            fleet.think_s, fleet.bandwidth_Bps,
            reconnect=lambda ls_sid=sid: self._connect(ls_sid),
            clock=self.clock)
        # route the session's ARQ mixin events (replays, reconnects,
        # duplicates, accept spans) into this run's tracer + registry
        ls.tracer = self.tracer
        ls.registry = self.registry
        ls.bind_instruments(self.registry)
        self.sessions[sid] = ls
        self.slots_in_use += 1
        ls.endpoint = self._connect(sid)
        self._push(now + ls.think(), lambda: self._send_event(ls))

    def _connect(self, sid: int):
        """Fresh channel onto session `sid` — initial and reconnect path.
        The server half becomes the session's pumped `_Conn`; the client
        half is optionally wrapped (fault injection), mirroring
        `engine.run_streaming._connect`."""
        cep, sep = channel_pair()
        ls = self.sessions[sid]
        old = ls.conn
        ls.conn = _Conn(sep)
        if old is not None and not old.retired:
            # the mixin's abandon notice is already in the old pipe; pump
            # it so the server retires that connection like a reader would
            self._push(self.clock.monotonic() + _EPS,
                       lambda: self._rx_event(ls, old))
        return (self.wrap_endpoint(sid, cep) if self.wrap_endpoint
                else cep)

    # -- client send / retry / reply ----------------------------------------

    def _send_event(self, ls: _LoadSession) -> None:
        if ls.finished:
            return
        now = self.clock.monotonic()
        comp, bottom = self._bottom(ls.spec())
        k, bits = getattr(comp, "k", self.cfg.d_model), getattr(comp, "bits",
                                                                0)
        ls.kb_trace.append((int(k), int(bits)))
        with self.tracer.span(SPAN_CLIENT_ENCODE, tid=session_tid(ls.id),
                              step=ls.step):
            # instantaneous in virtual time (compute is pre-warmed and
            # virtual-free): the span records ordering, not duration
            out = bottom(self.params, ls.cache, ls.next_token())
            frame_bytes, payload = encode_frame(ls.id, ls.step, out,
                                                self.lg.device_encode)
        hb = wire.payload_frame_header_nbytes(payload)
        ls.stats.count_up(header_nbytes=hb,
                          payload_nbytes=len(frame_bytes) - hb)
        self._m_cl_frames_up.inc()
        self._m_cl_payload_up.inc(len(frame_bytes) - hb)
        self._m_cl_framing_up.inc(hb)
        ls.endpoint.send(frame_bytes)
        ls.inflight = _InFlight(ls.step, frame_bytes, hb, t_send=now)
        conn = ls.conn
        tx = ls.tx_s(len(frame_bytes))
        if self.tracer.enabled:
            # the modeled uplink occupancy under the client's bandwidth cap
            self.tracer.complete(SPAN_WIRE_SEND, now, now + tx,
                                 tid=session_tid(ls.id), step=ls.step,
                                 nbytes=len(frame_bytes))
        self._push(now + tx, lambda: self._rx_event(ls, conn))
        self._arm_retry(ls)

    def _arm_retry(self, ls: _LoadSession) -> None:
        if self.lg.retry_timeout is None or ls.inflight is None:
            return
        inf = ls.inflight
        step, attempt = inf.step, inf.attempt
        self._push(self.clock.monotonic() + self.lg.retry_timeout,
                   lambda: self._retry_event(ls, step, attempt))

    def _retry_event(self, ls: _LoadSession, step: int, attempt: int) -> None:
        inf = ls.inflight
        if (ls.finished or inf is None or inf.step != step
                or inf.attempt != attempt):
            return                      # stale timer: the step moved on
        if self._drain_replies(ls):
            return                      # the reply was already in the pipe
        inf = ls.inflight
        if inf is None or inf.attempt != attempt:
            return                      # drain reconnected + replayed
        # genuine timeout — mirror `_await_reply`: spend a retry, maybe
        # reconnect to escape a stalled reader, retransmit
        inf.retries += 1
        if inf.retries > self.lg.max_retries:
            self._fail(ls, TimeoutError(
                f"session {ls.id}: no reply to frame {step} after "
                f"{inf.retries - 1} retransmissions"))
            return
        ls.stats.replays += 1
        if inf.retries % 8 == 0:
            ls._reconnect()             # fresh FrameReaders on both ends
        self._replay(ls)

    def _replay(self, ls: _LoadSession) -> None:
        inf = ls.inflight
        inf.attempt += 1
        ls._retransmit(inf.frame_bytes, inf.header_nbytes)
        conn = ls.conn
        self._push(self.clock.monotonic() + ls.tx_s(len(inf.frame_bytes)),
                   lambda: self._rx_event(ls, conn))
        self._arm_retry(ls)

    def _drain_replies(self, ls: _LoadSession) -> bool:
        """Drain the session's downlink; True iff the in-flight step
        completed. Runs the same classification/recovery the blocking
        `_await_reply` loop does, minus the waiting."""
        while ls.inflight is not None:
            step = ls.inflight.step
            try:
                reply = ls.endpoint.recv_frame(timeout=0.0)
            except wire.WireError:
                ls.stats.faults_detected += 1
                inf = ls.inflight
                inf.retries += 1
                if inf.retries > self.lg.max_retries:
                    self._fail(ls, TimeoutError(
                        f"session {ls.id}: retries exhausted recovering a "
                        f"corrupt downlink"))
                    return False
                ls.stats.replays += 1
                ls._reconnect()
                self._replay(ls)
                return False
            if reply is None:
                return False
            if reply.kind == wire.FRAME_ERROR:
                # peer rejected a frame and retired the connection
                ls.stats.count_down(reply.nbytes)
                inf = ls.inflight
                inf.retries += 1
                if inf.retries > self.lg.max_retries:
                    self._fail(ls, TimeoutError(
                        f"session {ls.id}: retries exhausted after peer "
                        f"rejections"))
                    return False
                ls.stats.replays += 1
                ls._reconnect()
                self._replay(ls)
                return False
            got = ls._accept_reply(reply, step)
            if got is not None:
                self._complete_step(ls, got)
                return True
        return False

    def _reply_event(self, ls: _LoadSession, depth_seen: int) -> None:
        """The reply's transmission delay elapsed: drain and, on step
        completion, feed the QoS controller its congestion view."""
        if ls.finished or ls.inflight is None:
            return
        before = ls.step
        if self._drain_replies(ls) and ls.qos is not None:
            ls.qos.observe(depth_seen, ls.latencies[before])

    def _complete_step(self, ls: _LoadSession, reply: wire.Frame) -> None:
        now = self.clock.monotonic()
        ls.latencies.append(now - ls.inflight.t_send)
        self.latency.add(ls.latencies[-1])
        self._m_cl_latency.observe(ls.latencies[-1] * 1e3)
        ls.inflight = None
        nxt = int(reply.tokens[0])
        if ls.step + 1 >= len(ls.prompt):
            ls.generated.append(nxt)
            ls.stats.tokens_out += 1
            self._m_cl_tokens.inc()
        ls.step += 1
        if ls.step < ls.n_steps:
            self._push(now + ls.think(), lambda: self._send_event(ls))
        else:
            self._finish(ls)

    def _finish(self, ls: _LoadSession) -> None:
        ls.finished = True
        ls.t_done = self.clock.monotonic()
        self.completed += 1
        ls.endpoint.send(wire.encode_close_frame(ls.id))
        conn = ls.conn
        close_nbytes = len(wire.encode_close_frame(ls.id))
        self._push(self.clock.monotonic() + ls.tx_s(close_nbytes),
                   lambda: self._rx_event(ls, conn, expect_close=True))

    def _fail(self, ls: _LoadSession, exc: BaseException) -> None:
        ls.finished = True
        ls.failed = exc
        ls.t_done = self.clock.monotonic()
        self.failed.append(ls.id)
        self._release_slot(ls, force=True)

    # -- server side ---------------------------------------------------------

    def _rx_event(self, ls: _LoadSession, conn: _Conn,
                  expect_close: bool = False) -> None:
        """A frame's uplink transmission finished: pump the connection (the
        reader-thread moment) and re-arm the flush timer."""
        if not conn.retired:
            status, conn.sid_seen = self.server.pump(conn.sep, conn.sid_seen)
            if status != "open":
                conn.retired = True
            if status == "closed":
                self._release_slot(ls)
        if expect_close and not ls.slot_released:
            # the CLOSE frame was lost to chaos (dropped/held/corrupted):
            # force the server-side close — the deterministic counterpart
            # of the threaded engine's shutdown() backstop
            sess = self.server.sessions.get(ls.id)
            if sess is not None:
                sess.closed = True
            self._release_slot(ls)
        self._arm_flush()

    def _release_slot(self, ls: _LoadSession, force: bool = False) -> None:
        if ls.slot_released:
            return
        ls.slot_released = True
        self.slots_in_use -= 1
        if force:
            sess = self.server.sessions.get(ls.id)
            if sess is not None:
                sess.closed = True

    def _arm_flush(self) -> None:
        due = self.server.queue.next_flush_at()
        if due is None:
            return
        due = max(due, self.server_free_at)
        if self._flush_armed is not None and self._flush_armed <= due + _EPS:
            return                      # an event at/before `due` is armed
        self._flush_armed = due
        self._push(due, self._flush_event)

    def _flush_event(self) -> None:
        self._flush_armed = None
        due = self.server.queue.next_flush_at()
        if due is None:
            return
        due = max(due, self.server_free_at)
        now = self.clock.monotonic()
        if due > now + _EPS:
            self._arm_flush()           # not actually due yet: re-arm
            return
        self._do_flush(now)
        self._arm_flush()               # backlog may already be flushable

    def _do_flush(self, now: float) -> None:
        q = self.server.queue
        depth = len(q)
        self.depth_at_flush.append(depth)
        batch = q.get_batch(idle_timeout=0.0)
        if not batch:
            return
        wire_bytes = sum(f.header_nbytes + f.payload_nbytes
                         for _, f in batch)
        self.server._process(batch)
        self.server_free_at = now + self.lg.service.flush_s(
            len(batch), wire_bytes)
        if self.tracer.enabled:
            # the ServiceModel's virtual occupancy of the server — the
            # span whose back-to-back packing is visible congestion
            self.tracer.name_track(_SERVICE_TID, "service model")
            self.tracer.complete("service.flush", now, self.server_free_at,
                                 cat="service", tid=_SERVICE_TID,
                                 rows=len(batch), wire_bytes=wire_bytes)
        for sess, frame in batch:
            ls = self.sessions.get(sess.id)
            if ls is None or ls.finished:
                continue
            reply_nbytes = (len(sess.last_reply)
                            if sess.last_reply is not None else 0)
            self._push(self.server_free_at + ls.tx_s(reply_nbytes),
                       functools.partial(self._reply_event, ls, depth))

    # -- report --------------------------------------------------------------

    def _report(self, wall_s_real: float) -> dict:
        lg = self.lg
        arrived = len(self.arrive_trace)
        admitted = len(self.sessions)
        reject_frac = len(self.rejects) / max(arrived, 1)
        tokens_out = sum(ls.stats.tokens_out for ls in self.sessions.values())
        makespan = max(self.t_end, _EPS)
        depth = np.asarray(self.depth_at_flush or [0])
        lat = self.latency.report()
        level_hist: Dict[int, int] = {}
        switches = 0
        for ls in self.sessions.values():
            if ls.qos is not None:
                switches += ls.qos.switches
                for kb in ls.kb_trace:
                    idx = ls.qos.levels.index(kb)
                    level_hist[idx] = level_hist.get(idx, 0) + 1
        slo = evaluate_slo(lg.slo, lat, reject_frac, int(depth.max()))
        report = {
            "seed": lg.seed,
            "virtual_duration_s": round(makespan, 6),
            "wall_s_real": wall_s_real,    # excluded from determinism checks
            "arrivals": {
                "process": lg.arrivals.process,
                "rate": lg.arrivals.rate,
                "burst_rate": (lg.arrivals.burst_rate
                               or 2 * lg.arrivals.rate),
                "state_path": [(round(t, 9), s)
                               for t, s in self.arrivals.state_path],
            },
            "sessions": {"arrived": arrived, "admitted": admitted,
                         "rejected": len(self.rejects),
                         "completed": self.completed,
                         "failed": len(self.failed)},
            "reject_frac": round(reject_frac, 6),
            "tokens_out": tokens_out,
            "goodput_tok_per_s": round(tokens_out / makespan, 4),
            "latency_ms": {k: (v if isinstance(v, bool) else round(v, 4))
                           for k, v in lat.items()},
            "queue_depth": {"max": int(depth.max()),
                            "mean": round(float(depth.mean()), 4)},
            "flushes": len(self.server.batch_sizes),
            "mean_batch_fill": round(float(np.mean(
                self.server.batch_sizes or [0])), 4),
            "bytes_up_per_token": round(
                sum(ls.stats.payload_bytes_up
                    for ls in self.sessions.values())
                / max(tokens_out, 1), 3),
            "qos": {"enabled": lg.qos is not None,
                    "ladder": (list(map(list, lg.qos.ladder()))
                               if lg.qos else []),
                    "level_hist": {str(k): v for k, v
                                   in sorted(level_hist.items())},
                    "switches": switches},
            "fault_counters": _engine.fault_summary(
                self.server, list(self.sessions.values())),
            "metrics": self.registry.snapshot(),
            "metrics_timeline": [],     # the reference's periodic
            #   snapshots; no snapshot interval is ported, so always empty
            "trace_events": len(self.tracer) if self.tracer.enabled else 0,
            "slo": slo,
            "cv_waits": self.clock.waits,   # 0 == no real sleeps ever
            "trace": {
                "arrivals": list(self.arrive_trace),
                "rejects": [list(r) for r in self.rejects],
                "k_bits": {str(sid): [list(kb) for kb in ls.kb_trace]
                           for sid, ls in sorted(self.sessions.items())},
            },
            "served": {
                "tokens": {str(sid): [int(t) for t in ls.generated]
                           for sid, ls in sorted(self.sessions.items())},
                "decode_groups": dict(sorted(
                    self.server.decode_groups.items())),
                "mixed_meta_flushes": self.server.mixed_meta_flushes,
            },
        }
        return report


def evaluate_slo(slo: SLOSpec, latency_ms: dict, reject_frac: float,
                 max_depth: int) -> dict:
    """Grade one run's aggregates against the declared SLOs."""
    checks = {"p99": bool(latency_ms["p99_ms"] <= slo.p99_ms
                          or latency_ms["n"] == 0),
              "rejects": bool(reject_frac <= slo.max_reject_frac)}
    if slo.p50_ms:
        checks["p50"] = bool(latency_ms["p50_ms"] <= slo.p50_ms)
    if slo.max_queue_depth:
        checks["queue_depth"] = bool(max_depth <= slo.max_queue_depth)
    return {"targets": dataclasses.asdict(slo),
            "checks": checks, "ok": all(checks.values())}


def run_loadgen(cfg: ArchConfig, lg: LoadGenConfig, *, params=None,
                wrap_endpoint=None, trace_path=None, device=None) -> dict:
    """Run one traffic scenario; returns the deterministic SLO report
    (`wall_s_real` is the only nondeterministic field). `wrap_endpoint` is
    the same fault-injection hook `engine.run_streaming` takes.

    `params` are the port's weights, or None for random weights from
    `torch.Generator(lg.seed)`. Runs on the card unless `device="cpu"`;
    `cfg.split.backend` picks the kernels (None) or their plain versions
    ("torch").

    `trace_path` (optional) enables lifecycle tracing on the virtual clock
    and writes the run's Chrome-trace JSON there — byte-identical across
    same-seed runs, and to the reference's."""
    harness = _Harness(cfg, lg, params, wrap_endpoint,
                       trace=trace_path is not None, device=device)
    report = harness.run()
    errs = [(sid, harness.sessions[sid].failed) for sid in harness.failed]
    report["failures"] = [[sid, str(e)] for sid, e in errs]
    if trace_path is not None:
        write_trace(harness.tracer, trace_path)
    return report
