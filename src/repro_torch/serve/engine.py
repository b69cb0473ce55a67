"""Serving tier: continuous batching with a CARE request dispatcher.

Port of the fixed-horizon and the streaming engine of
``repro/serve/engine.py``: requests are jobs, replica groups are servers,
and the front end routes each arriving request over the dispatcher's
*approximated* per-replica occupancy, which replicas correct through the
shared push trigger core (:mod:`repro_torch.core.care.comm`) only when it
fires.

A slot is one decode iteration across replicas.  In every slot, in this
order: the slot's arrivals are routed one lane at a time (each routed
request bumps the occupancy the next one sees) into per-replica pending
rings of ``queue_cap`` requests (a full ring drops the request, counted);
free decode slots admit from the rings, FIFO; every active decode slot
works one unit (or its replica's credit-schedule units under
``decode_rates``); the emulated occupancy drains by ``msr_drain`` per busy
replica; the trigger fires and snaps the emulation to the truth.

Configuration is split as in the reference: :class:`EngineStatic` holds
shapes and kinds (Python-level dispatch), :class:`EngineScenario` the
numeric operands, one row per run once stacked.  ``serve_grid`` runs every
(cell, seed) pair as one leading run axis, flattened cell-major
(``run = cell * S + seed``); ``lax.scan`` over slots becomes a Python loop
that stops at the largest horizon (one kernel launch for the fused
backend on the card), and slots past a run's horizon are frozen no-ops.

The workload is sampled host-side with numpy exactly as the reference
samples it (:func:`sample_workload`, the same ``SeedSequence(seed).spawn(6)``
streams), so both engines consume byte-identical arrays.  The emulated
occupancy is float32 and every drain and score product is one IEEE
single-precision operation, so the port equals the reference bit for bit.

Two backends route the arrival lanes (``route_backend``):

* ``"dense"`` -- the reference's per-lane body as a Python loop over lanes,
  for the policies ``jsaq`` / ``sqd`` / ``rr`` / ``drain`` and the pull
  policies ``jiq`` / ``hsq`` (a balancer-side token pool) with random or
  lowest-index ties, and the degraded control plane;
* ``"fused"`` -- the counterpart of the reference's ``"pallas"`` backend;
  it refuses what that backend refuses.  On the card the whole slot loop is
  one ``serve_slots`` launch per call
  (:func:`repro_torch.kernels.ops.serve_slots`); on the CPU it is the
  kernel's plain version, the per-slot loop with one
  :func:`repro_torch.kernels.ops.serve_route` call a slot for all runs.

The degraded control plane runs on the dense backend (the fused one
refuses it, as the reference's pallas backend does): replica faults
(``fault``, advanced after routing; a crashed replica admits, decodes and
sends nothing, and resyncs on recovery), the wire (``network="net"``,
``transport`` fire-and-forget or ack; the dispatcher's approximation and
token pool take the *delivered* snapshot; SQ(d)'s ``2 d`` queries a
routed request are billed) and suspect masking (``suspect_age``).

The streaming (segment) engine, :func:`serve_stream`, runs a cell as chunks
of slots in O(chunk) memory: :class:`StreamSampler` draws each chunk's
slab (prefix-stable blocks, byte-identical to the reference's), the engine
state (:class:`EngineCarry`) resumes from one chunk to the next on the
absolute slot clock, a request's ring entry is its arrival slot, and every
slot's completions fold into the :class:`StreamMetrics` JCT accumulators.
On the card the fused backend runs one ``serve_slots`` launch a chunk,
which updates the carry in place.

The per-request dispatcher, :class:`CareDispatcher` (driven slot by slot
by :func:`run_serving_sim`), is the pluggable path: it routes one request
at a time and calls a per-slot ``model_fn`` hook.  Its rings grow instead
of dropping, its rids and remaining work are int64, and it equals
``serve_one`` on the same workload wherever ``serve_one`` drops nothing.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Literal, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.care import comm as comm_lib
from repro_torch.core.care import metrics as metrics_lib
from repro_torch.core.care import routing as routing_lib
from repro_torch.core.care import workload as workload_lib
from repro_torch.core.care.slotted_sim import _resolve_device
from repro_torch.kernels import ops as kernel_ops

_I32 = torch.int32
_F32 = torch.float32

# The serving tier's routing policies (see the reference): ``jsaq`` joins
# the shortest approximated queue; ``sqd`` the shortest of ``sqd`` sampled
# replicas; ``rr`` is round robin; ``drain`` minimises ``occ_i * E[S] / r_i``
# under heterogeneous ``decode_rates``.  ``jiq`` / ``hsq`` are the pull
# family.
ServePolicy = Literal["jsaq", "sqd", "rr", "drain", "jiq", "hsq"]
PUSH_POLICIES = ("jsaq", "sqd", "rr", "drain")
PULL_POLICIES = comm_lib.PULL_KINDS

# Pre-drawn subset-uniform lane width of ServeWorkload.sub_u: SQ(d) cells
# need d <= SQD_MAX.  Fixed so cells differing only in policy / d share one
# workload stream.
SQD_MAX = 8


def mean_decode_rate(decode_rates: Optional[Sequence[float]]) -> float:
    """Mean per-replica decode rate: the capacity multiplier of a profile.

    The workload stream is keyed on this value, so every consumer derives
    it the same way.
    """
    if decode_rates is None:
        return 1.0
    return float(np.mean(np.asarray(decode_rates, np.float64)))


@dataclasses.dataclass
class Request:
    """One request of the per-request dispatcher; ``started`` / ``finished``
    are the slots it was admitted and completed in (-1 until then)."""

    rid: int
    arrival: int
    prefill_cost: int  # slots of prefill work
    decode_len: int  # decode iterations to complete
    started: int = -1
    finished: int = -1


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """The per-request dispatcher's parameters (:class:`CareDispatcher`).

    ``comm`` is one of ``et`` / ``dt`` / ``rt`` / ``et_rt`` / ``exact`` /
    ``jiq`` / ``hsq``; ``deterministic_ties`` breaks ties to the lowest
    index instead of by the pre-drawn float32 rank.  The control plane's
    fields are :class:`ServeConfig`'s.
    """

    num_replicas: int = 8
    decode_slots: int = 16  # concurrent sequences per replica
    et_x: int = 4  # ET threshold on queue-occupancy error
    comm: str = "et"
    dt_x: int = 4
    rt_period: int = 16
    msr_drain: float = 1.0  # emulated completions per slot per busy replica
    policy: ServePolicy = "jsaq"
    sqd: int = 2  # subset size of the "sqd" policy
    # Per-replica decode speeds in work units per decode iteration; None =
    # unit rates.
    decode_rates: Optional[Tuple[float, ...]] = None
    # Mean request work components; the "drain" policy's E[S] term.
    mean_prefill: float = 4.0
    mean_decode: float = 64.0
    deterministic_ties: bool = False
    network: str = "none"  # "none" | "net"
    net_delay: int = 0
    net_jitter: int = 0
    net_drop: float = 0.0
    suspect_age: int = 0  # staleness bound in slots (0 = no suspect masking)
    transport: str = "fire_forget"  # "fire_forget" | "ack"
    ack_timeout: int = 0
    backoff_base: float = 1.0
    max_retries: int = 0
    ka_period: int = 0
    fault: str = "none"  # "none" | "crash" | "slow"
    crash_rate: float = 0.0
    recover_rate: float = 0.0
    slow_factor: float = 1.0

    def comm_config(self) -> comm_lib.CommConfig:
        """This tier's trigger parameters in shared-core terms."""
        if self.comm == "et":
            return comm_lib.CommConfig(kind="et", x=self.et_x)
        if self.comm == "dt":
            return comm_lib.CommConfig(kind="dt", x=self.dt_x)
        if self.comm == "rt":
            return comm_lib.CommConfig(kind="rt", rt_period=self.rt_period)
        if self.comm == "et_rt":
            return comm_lib.CommConfig(kind="et_rt", x=self.et_x, rt_period=self.rt_period)
        if self.comm == "exact":
            return comm_lib.CommConfig(kind="exact")
        if self.comm == "jiq":
            return comm_lib.CommConfig(kind="jiq")
        if self.comm == "hsq":
            # hsq reads the ET threshold as its queue threshold and the RT
            # period as its token-refresh period.
            return comm_lib.CommConfig(kind="hsq", x=self.et_x, rt_period=self.rt_period)
        raise ValueError(f"unknown comm mode: {self.comm}")


@dataclasses.dataclass(frozen=True)
class EngineStatic:
    """Shapes and kinds of a serving run (hashable).

    ``slots`` is the *padded* loop length (each cell's effective length is
    its ``EngineScenario.horizon``) and ``max_arrivals`` the padded
    per-slot arrival-lane width (0 = derive from the sampled workload).
    ``trace_occupancy`` also returns the end-of-slot per-replica
    occupancy.  ``network`` / ``transport`` / ``fault`` are the control
    plane's kinds; ``stream`` is :func:`serve_stream`'s segment mode (the
    carry resumes at an absolute slot clock, ring entries are arrival slots
    and completions fold into :class:`StreamMetrics`), where ``slots`` is
    the chunk length.
    """

    replicas: int = 8
    decode_slots: int = 16
    queue_cap: int = 512
    slots: int = 20_000
    comm: str = "et"
    policy: ServePolicy = "jsaq"
    sqd: int = 2
    use_rates: bool = False
    max_arrivals: int = 0
    trace_occupancy: bool = False
    route_backend: str = "dense"  # "dense" | "fused"
    deterministic_ties: bool = False
    network: str = "none"
    transport: str = "fire_forget"
    fault: str = "none"
    stream: bool = False


def _check_static(static: EngineStatic) -> None:
    """Refuse unknown kinds.

    The ``"fused"`` backend refuses exactly what the reference's
    ``"pallas"`` backend refuses (``ServeConfig.static_part``), in the
    fixed horizon and in stream mode alike.
    """
    if static.route_backend not in ("dense", "fused"):
        raise ValueError(
            f"route_backend must be 'dense' or 'fused', got {static.route_backend!r}"
        )
    if static.route_backend == "fused":
        if static.policy != "jsaq":
            raise ValueError(
                f"route_backend='fused' supports policy 'jsaq' only, got "
                f"{static.policy!r}"
            )
        if not static.deterministic_ties:
            raise ValueError(
                "route_backend='fused' requires deterministic_ties=True (the "
                "kernel breaks ties to the lowest index)"
            )
        if static.network != "none" or static.fault != "none":
            raise NotImplementedError(
                f"route_backend='fused' does not support the degraded control "
                f"plane (network={static.network!r}, fault={static.fault!r}); "
                f"use route_backend='dense'"
            )
    for name, value, allowed in (
        ("network", static.network, ("none", "net")),
        ("transport", static.transport, ("fire_forget", "ack")),
        ("fault", static.fault, ("none", "crash", "slow")),
    ):
        if value not in allowed:
            raise ValueError(f"unknown {name} kind: {value!r}")
    if static.policy not in PUSH_POLICIES + PULL_POLICIES:
        raise ValueError(f"unknown policy: {static.policy!r}")
    if static.comm not in comm_lib.PUSH_KINDS + comm_lib.PULL_KINDS:
        raise ValueError(f"unknown communication kind: {static.comm!r}")
    comm_lib.validate_control_plane(policy=static.policy, comm=static.comm)


@dataclasses.dataclass(frozen=True)
class EngineScenario:
    """Numeric operands of serving cells: 0-d tensors (``decode_rates``
    ``(R,)``) for one cell, with a leading run axis once stacked by
    :func:`stack_scenarios`.  float32 / int32 as the reference carries
    them; ``load`` rides along for reporting, ``mean_prefill`` /
    ``mean_decode`` feed the ``drain`` policy's E[S] term.  The
    control-plane operands are neutral when their kinds are off.
    ``warmup`` (stream mode) is the absolute slot before which completions
    stay out of the JCT accumulators."""

    load: torch.Tensor
    x: torch.Tensor
    rt_period: torch.Tensor
    msr_drain: torch.Tensor
    mean_prefill: torch.Tensor
    mean_decode: torch.Tensor
    decode_rates: torch.Tensor
    horizon: torch.Tensor
    net_delay: torch.Tensor
    net_jitter: torch.Tensor
    net_drop: torch.Tensor
    suspect_age: torch.Tensor
    ack_timeout: torch.Tensor
    backoff_base: torch.Tensor
    max_retries: torch.Tensor
    ka_period: torch.Tensor
    crash_rate: torch.Tensor
    recover_rate: torch.Tensor
    slow_factor: torch.Tensor
    warmup: torch.Tensor

    @staticmethod
    def create(
        load: float,
        x: float = 4.0,
        rt_period: int = 16,
        msr_drain: float = 1.0,
        mean_prefill: float = 4,
        mean_decode: float = 64,
        horizon: Optional[int] = None,
        replicas: int = 8,
        decode_rates: Optional[Sequence[float]] = None,
        net_delay: int = 0,
        net_jitter: int = 0,
        net_drop: float = 0.0,
        suspect_age: int = 0,
        ack_timeout: int = 0,
        backoff_base: float = 1.0,
        max_retries: int = 0,
        ka_period: int = 0,
        crash_rate: float = 0.0,
        recover_rate: float = 0.0,
        slow_factor: float = 1.0,
        warmup: int = 0,
    ) -> "EngineScenario":
        if horizon is None:
            horizon = np.iinfo(np.int32).max
        rates = (
            torch.ones((replicas,), dtype=_F32)
            if decode_rates is None
            else torch.tensor(list(decode_rates), dtype=_F32)
        )

        def f32(v):
            return torch.tensor(float(v), dtype=_F32)

        def i32(v):
            return torch.tensor(int(v), dtype=_I32)

        return EngineScenario(
            load=f32(load), x=f32(x), rt_period=i32(rt_period),
            msr_drain=f32(msr_drain), mean_prefill=f32(mean_prefill),
            mean_decode=f32(mean_decode), decode_rates=rates,
            horizon=i32(horizon), net_delay=i32(net_delay),
            net_jitter=i32(net_jitter), net_drop=f32(net_drop),
            suspect_age=i32(suspect_age), ack_timeout=i32(ack_timeout),
            backoff_base=f32(backoff_base), max_retries=i32(max_retries),
            ka_period=i32(ka_period), crash_rate=f32(crash_rate),
            recover_rate=f32(recover_rate), slow_factor=f32(slow_factor),
            warmup=i32(warmup),
        )

    def to(self, device) -> "EngineScenario":
        return EngineScenario(**{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
        })


def stack_scenarios(scenarios: Sequence[EngineScenario]) -> EngineScenario:
    """Stack unbatched cells into one batched scenario (leading run axis)."""
    return EngineScenario(**{
        f.name: torch.stack([getattr(s, f.name) for s in scenarios])
        for f in dataclasses.fields(EngineScenario)
    })


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """One serving grid cell as the user sees it (hashable).

    Splits into :meth:`static_part` and :meth:`scenario`; ``load`` /
    ``mean_prefill`` / ``mean_decode`` also parameterise the host-side
    workload sampler (:meth:`workload_key`).  ``route_backend`` is
    ``"dense"`` or ``"fused"``; ``deterministic_ties`` breaks ties to the
    lowest index instead of by the pre-drawn uniform rank.  The control
    plane: ``network="net"`` with ``net_delay`` / ``net_jitter`` /
    ``net_drop``; ``transport="ack"`` with ``ack_timeout`` /
    ``backoff_base`` / ``max_retries`` / ``ka_period``; ``fault`` crash /
    slow with ``crash_rate`` / ``recover_rate`` / ``slow_factor``; and
    ``suspect_age`` (0 = no suspect masking).  For hsq, ``x`` is the
    token threshold and ``rt_period`` the token-refresh period.
    """

    replicas: int = 8
    decode_slots: int = 16
    slots: int = 20_000
    load: float = 0.9
    comm: str = "et"
    x: float = 4.0
    rt_period: int = 16
    msr_drain: float = 1.0
    mean_prefill: int = 4
    mean_decode: int = 64
    queue_cap: int = 512
    policy: ServePolicy = "jsaq"
    sqd: int = 2
    decode_rates: Optional[Tuple[float, ...]] = None
    max_slots: Optional[int] = None
    max_arrivals: int = 0
    route_backend: str = "dense"
    deterministic_ties: bool = False
    network: str = "none"
    net_delay: int = 0
    net_jitter: int = 0
    net_drop: float = 0.0
    suspect_age: int = 0
    transport: str = "fire_forget"
    ack_timeout: int = 0
    backoff_base: float = 1.0
    max_retries: int = 0
    ka_period: int = 0
    fault: str = "none"
    crash_rate: float = 0.0
    recover_rate: float = 0.0
    slow_factor: float = 1.0

    def rate_scale(self) -> float:
        """Mean decode rate: the capacity multiplier of heterogeneity."""
        return mean_decode_rate(self.decode_rates)

    def arrival_rate(self) -> float:
        """Offered per-slot arrival rate: load x service capacity."""
        mean_work = self.mean_prefill + self.mean_decode
        return (
            self.load * self.replicas * self.decode_slots
            * self.rate_scale() / mean_work
        )

    def static_part(self) -> EngineStatic:
        if self.max_slots is not None and self.max_slots < self.slots:
            raise ValueError(
                f"max_slots ({self.max_slots}) must be >= slots ({self.slots})"
            )
        if self.policy == "sqd" and not 1 <= self.sqd <= min(self.replicas, SQD_MAX):
            raise ValueError(
                f"sqd ({self.sqd}) must be in [1, min(replicas, {SQD_MAX})]"
            )
        if self.decode_rates is not None and len(self.decode_rates) != self.replicas:
            raise ValueError(
                f"decode_rates has {len(self.decode_rates)} entries for "
                f"{self.replicas} replicas"
            )
        static = EngineStatic(
            replicas=self.replicas,
            decode_slots=self.decode_slots,
            queue_cap=self.queue_cap,
            slots=self.max_slots if self.max_slots is not None else self.slots,
            comm=self.comm,
            policy=self.policy,
            # Only "sqd" reads the subset size; normalising it lets cells
            # that differ in the unused knob share one static part.
            sqd=self.sqd if self.policy == "sqd" else 0,
            use_rates=self.decode_rates is not None,
            max_arrivals=self.max_arrivals,
            route_backend=self.route_backend,
            deterministic_ties=self.deterministic_ties,
            network=self.network,
            transport=self.transport,
            fault=self.fault,
        )
        _check_static(static)
        comm_lib.validate_control_plane(
            network=self.network, net_delay=self.net_delay,
            net_jitter=self.net_jitter, net_drop=self.net_drop,
            suspect_age=self.suspect_age, fault=self.fault,
            crash_rate=self.crash_rate, recover_rate=self.recover_rate,
            slow_factor=self.slow_factor, policy=self.policy, comm=self.comm,
            token_refresh=float(self.rt_period) if self.policy == "hsq" else None,
            transport=self.transport, ack_timeout=self.ack_timeout,
            backoff_base=self.backoff_base, max_retries=self.max_retries,
            ka_period=self.ka_period,
        )
        if self.network != "none" and self.comm == "exact":
            raise ValueError(
                "comm='exact' assumes instant delivery (per-departure "
                "accounting); it cannot compose with network="
                f"{self.network!r}"
            )
        return static

    def scenario(self) -> EngineScenario:
        return EngineScenario.create(
            load=self.load, x=self.x, rt_period=self.rt_period,
            msr_drain=self.msr_drain, mean_prefill=self.mean_prefill,
            mean_decode=self.mean_decode, horizon=self.slots,
            replicas=self.replicas, decode_rates=self.decode_rates,
            net_delay=self.net_delay, net_jitter=self.net_jitter,
            net_drop=self.net_drop, suspect_age=self.suspect_age,
            ack_timeout=self.ack_timeout, backoff_base=self.backoff_base,
            max_retries=self.max_retries, ka_period=self.ka_period,
            crash_rate=self.crash_rate, recover_rate=self.recover_rate,
            slow_factor=self.slow_factor,
        )

    def engine_config(self) -> EngineConfig:
        """This cell's dispatcher parameters (:class:`CareDispatcher`)."""
        x = int(self.x) if float(self.x).is_integer() else self.x
        return EngineConfig(
            num_replicas=self.replicas, decode_slots=self.decode_slots, et_x=x,
            comm=self.comm, dt_x=x, rt_period=self.rt_period, msr_drain=self.msr_drain,
            policy=self.policy, sqd=self.sqd, decode_rates=self.decode_rates,
            mean_prefill=float(self.mean_prefill), mean_decode=float(self.mean_decode),
            deterministic_ties=self.deterministic_ties, network=self.network,
            net_delay=self.net_delay, net_jitter=self.net_jitter, net_drop=self.net_drop,
            suspect_age=self.suspect_age, transport=self.transport,
            ack_timeout=self.ack_timeout, backoff_base=self.backoff_base,
            max_retries=self.max_retries, ka_period=self.ka_period, fault=self.fault,
            crash_rate=self.crash_rate, recover_rate=self.recover_rate,
            slow_factor=self.slow_factor,
        )

    def workload_key(self) -> tuple:
        """The sampler's parameter tuple: cells sharing it share a stream.

        Keyed on the *mean* decode rate, not the rate profile, and on the
        presence of the control-plane streams, as the reference keys it;
        routing and trigger parameters never enter.
        """
        return (
            self.replicas, self.decode_slots, self.slots, self.load,
            self.mean_prefill, self.mean_decode, self.rate_scale(),
            self.network != "none", self.fault != "none",
            self.transport == "ack",
        )


# ---------------------------------------------------------------------------
# Host-side workload sampling: the reference's stream, byte for byte.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ServeWorkload:
    """Pre-sampled request stream (host-side numpy; rid = arrival order).

    ``tie_u`` / ``sub_u`` are float32 at the source, so tie-break and
    subset ranks are the same float32 products on every backend.  The
    control-plane streams are ``None`` unless their kind is on.
    """

    n_arr: np.ndarray  # (T,) int64 arrivals per slot
    base: np.ndarray  # (T,) int64 rid of the first arrival in each slot
    prefill: np.ndarray  # (N,) int64 per-request prefill cost (>= 1)
    decode: np.ndarray  # (N,) int64 per-request decode length (>= 1)
    work: np.ndarray  # (N,) int64 total slot occupancy, max(p + d, 1)
    tie_u: np.ndarray  # (N,) float32 routing tie-break uniforms
    sub_u: np.ndarray  # (N, SQD_MAX) float32 SQ(d) subset uniforms
    arrival_slot: np.ndarray  # (N,) int64
    net_drop_u: Optional[np.ndarray] = None  # (T, R) float32
    net_jit_u: Optional[np.ndarray] = None  # (T, R) float32
    fault_u: Optional[np.ndarray] = None  # (T, R) float32
    ack_u: Optional[np.ndarray] = None  # (T, 4, R) float32

    @property
    def total(self) -> int:
        return int(self.work.shape[0])

    @staticmethod
    def from_arrays(obj) -> "ServeWorkload":
        """Copy the numpy fields of any object that has them (such as the
        reference's ``ServeWorkload``) into a port workload."""
        fields = {}
        for f in dataclasses.fields(ServeWorkload):
            if f.default is dataclasses.MISSING:
                fields[f.name] = np.array(getattr(obj, f.name))
            else:
                value = getattr(obj, f.name, None)
                fields[f.name] = None if value is None else np.array(value)
        return ServeWorkload(**fields)


def sample_workload(
    seed: int,
    *,
    replicas: int,
    decode_slots: int,
    slots: int,
    load: float,
    mean_prefill: float = 4,
    mean_decode: float = 64,
    rate_scale: float = 1.0,
    with_net: bool = False,
    with_fault: bool = False,
    with_ack: bool = False,
) -> ServeWorkload:
    """Draw the replayable serving workload for one (parameters, seed).

    The reference's sampler, line for line: arrivals/sizes, routing
    tie-breaks, SQ(d) subset draws and the control-plane uniforms come from
    independent, prefix-stable ``SeedSequence`` children, so the arrays
    are byte-identical to the reference's.
    """
    w_ss, r_ss, s_ss, n_ss, f_ss, a_ss = (
        np.random.SeedSequence(int(seed)).spawn(6)
    )
    wrng = np.random.default_rng(w_ss)
    rrng = np.random.default_rng(r_ss)
    srng = np.random.default_rng(s_ss)
    mean_work = mean_prefill + mean_decode
    rate = load * replicas * decode_slots * rate_scale / mean_work
    n_arr = wrng.poisson(rate, size=slots).astype(np.int64)
    total = int(n_arr.sum())
    prefill = 1 + wrng.poisson(mean_prefill, size=total).astype(np.int64)
    decode = 1 + wrng.poisson(mean_decode, size=total).astype(np.int64)
    work = np.maximum(prefill + decode, 1)
    tie_u = rrng.random(size=total, dtype=np.float32)
    sub_u = srng.random(size=(total, SQD_MAX), dtype=np.float32)
    base = np.concatenate([[0], np.cumsum(n_arr)[:-1]]).astype(np.int64)
    arrival_slot = np.repeat(np.arange(slots, dtype=np.int64), n_arr)
    net_drop_u = net_jit_u = fault_u = ack_u = None
    if with_net:
        nrng = np.random.default_rng(n_ss)
        net_drop_u = nrng.random(size=(slots, replicas), dtype=np.float32)
        net_jit_u = nrng.random(size=(slots, replicas), dtype=np.float32)
    if with_fault:
        frng = np.random.default_rng(f_ss)
        fault_u = frng.random(size=(slots, replicas), dtype=np.float32)
    if with_ack:
        arng = np.random.default_rng(a_ss)
        ack_u = arng.random(size=(slots, 4, replicas), dtype=np.float32)
    return ServeWorkload(
        n_arr=n_arr, base=base, prefill=prefill, decode=decode,
        work=work, tie_u=tie_u, sub_u=sub_u, arrival_slot=arrival_slot,
        net_drop_u=net_drop_u, net_jit_u=net_jit_u, fault_u=fault_u,
        ack_u=ack_u,
    )


@functools.lru_cache(maxsize=512)
def _cached_workload(key: tuple, seed: int) -> ServeWorkload:
    (replicas, decode_slots, slots, load, mean_prefill, mean_decode,
     rate_scale, with_net, with_fault, with_ack) = key
    return sample_workload(
        seed, replicas=replicas, decode_slots=decode_slots, slots=slots,
        load=load, mean_prefill=mean_prefill, mean_decode=mean_decode,
        rate_scale=rate_scale, with_net=with_net, with_fault=with_fault,
        with_ack=with_ack,
    )


def workload_for(cell: ServeConfig, seed: int) -> ServeWorkload:
    """The (memoised) workload of one cell x seed.  Cells differing only
    in routing or trigger parameters share the stream."""
    return _cached_workload(cell.workload_key(), int(seed))


def subset_mask(u_row: torch.Tensor, n: int, d: int) -> torch.Tensor:
    """SQ(d) candidate mask: ``d`` distinct of ``n`` replicas from uniforms.

    A partial Fisher-Yates draw consuming ``u_row[..., :d]`` (float32, from
    ``ServeWorkload.sub_u``): step ``i`` picks the ``k``-th of the ``n-i``
    still-available replicas with ``k = min(int(f32(u_i) * f32(n-i)),
    n-i-1)``, the reference's float32/int32 arithmetic.  Leading axes of
    ``u_row`` are batch axes; returns ``(..., n)`` bool.
    """
    batch = u_row.shape[:-1]
    avail = torch.ones((*batch, n), dtype=torch.bool, device=u_row.device)
    mask = torch.zeros_like(avail)
    for i in range(d):
        m = n - i
        k = torch.clamp_max((u_row[..., i] * float(m)).to(_I32), m - 1)
        cum = avail.cumsum(-1, dtype=_I32)
        pick = avail & (cum == (k + 1)[..., None])
        mask = mask | pick
        avail = avail & ~pick
    return mask


def _pick_min_tied(occ: torch.Tensor, u: float, mask: Optional[torch.Tensor] = None,
                   deterministic: bool = False) -> torch.Tensor:
    """:func:`pick_min_tied` as a 0-d int64 tensor on ``occ``'s device."""
    if mask is not None:
        occ = torch.where(mask, occ, torch.inf)
    is_min = occ == occ.amin()
    if deterministic:
        j = torch.argmax(is_min.to(_I32))
    else:
        n_ties = is_min.sum(dtype=_I32)
        rank = torch.minimum((n_ties.to(_F32) * u).to(_I32), n_ties - 1)
        j = torch.argmax((is_min.cumsum(0, dtype=_I32) == rank + 1).to(_I32))
    if mask is not None:
        j = torch.where(mask.any(), j, -1)
    return j


def pick_min_tied(occ, u: float, mask=None, deterministic: bool = False) -> int:
    """Index of the minimum of ``occ`` ``(R,)``; ties broken by the uniform ``u``.

    The rank is ``int(f32(u) * f32(n_ties))`` clamped to ``n_ties - 1``
    (``u`` from a float32 draw, such as ``ServeWorkload.tie_u``);
    ``deterministic=True`` takes the lowest index.  ``mask`` (bool
    ``(R,)``) restricts the minimum to the candidates (non-candidates are
    lifted to ``+inf``, so the tie set is the candidates'); an all-False
    mask returns ``-1``.  Arrays or tensors; the result is a Python int.
    """
    occ = torch.as_tensor(occ)
    if mask is not None:
        mask = torch.as_tensor(mask, device=occ.device)
    return int(_pick_min_tied(occ, float(u), mask, deterministic))


# ---------------------------------------------------------------------------
# The per-request dispatcher: the pluggable path with a per-slot model hook.
# ---------------------------------------------------------------------------


class CareDispatcher:
    """Policy routing over approximated occupancy + shared-core triggers.

    Port of the reference's numpy dispatcher.  Its per-replica state is
    torch tensors on ``device`` (``None`` means the CUDA card): the decode
    slots ``active_rem`` / ``active_rid`` (``<= 0`` remaining == free), the
    FIFO rings of pending request ids ``_q_rid`` / ``_q_head`` / ``_q_len``
    (grown by doubling, so nothing is dropped), the float32 emulated
    occupancy ``approx``, the pull-token pool and the fault mask; rids and
    remaining work are int64.  The trigger, wire, fault and service steps
    are the shared core's (:mod:`repro_torch.core.care.comm`,
    :mod:`repro_torch.core.care.workload`).

    ``route`` places one request and returns the replica as a Python int:
    on the card that is one synchronisation a request (the replica, its
    ring length and head, and its token count come back together).
    ``step`` advances one slot and returns the requests that finished in
    it (one copy to the host a slot).  ``rng`` (or
    ``np.random.default_rng(seed)``) draws the tie-break and subset
    uniforms, as float32, when ``route`` is not given them.
    """

    def __init__(
        self,
        cfg: EngineConfig,
        seed: int = 0,
        queue_cap: int = 4096,
        rng: Optional[np.random.Generator] = None,
        device: str | torch.device | None = None,
    ):
        r, s = cfg.num_replicas, cfg.decode_slots
        if cfg.policy == "sqd" and not 1 <= cfg.sqd <= min(r, SQD_MAX):
            raise ValueError(
                f"sqd ({cfg.sqd}) must be in [1, min(num_replicas, {SQD_MAX})]"
            )
        if cfg.decode_rates is not None and len(cfg.decode_rates) != r:
            raise ValueError(
                f"decode_rates has {len(cfg.decode_rates)} entries for {r} replicas"
            )
        comm_lib.validate_control_plane(
            network=cfg.network, net_delay=cfg.net_delay, net_jitter=cfg.net_jitter,
            net_drop=cfg.net_drop, suspect_age=cfg.suspect_age, fault=cfg.fault,
            crash_rate=cfg.crash_rate, recover_rate=cfg.recover_rate,
            slow_factor=cfg.slow_factor, policy=cfg.policy, comm=cfg.comm,
            token_refresh=float(cfg.rt_period) if cfg.policy == "hsq" else None,
        )
        if cfg.network != "none" and cfg.comm == "exact":
            raise ValueError(
                "comm='exact' assumes instant delivery (per-departure "
                "accounting); it cannot compose with network="
                f"{cfg.network!r}"
            )
        dev = _resolve_device(device)
        self.device = dev
        self.cfg = cfg
        self._ccfg = cfg.comm_config()

        def f32(value):
            return torch.tensor(np.float32(value), device=dev)

        def i32(value):
            return torch.tensor(int(value), dtype=_I32, device=dev)

        # The wire (network="net", fire-and-forget or ack) and the fault
        # mask; the operands are device scalars, so a step copies nothing.
        self.net = None
        self._ncfg = None
        if cfg.network != "none":
            state = comm_lib.AckNetState if cfg.transport == "ack" else comm_lib.NetState
            self.net = state.init(r, device=dev, payload_dtype=_F32)
            self._ncfg = comm_lib.NetworkConfig(
                kind=cfg.network, delay=i32(cfg.net_delay), jitter=i32(cfg.net_jitter),
                drop=f32(cfg.net_drop), transport=cfg.transport,
                ack_timeout=i32(cfg.ack_timeout), backoff_base=f32(cfg.backoff_base),
                max_retries=i32(cfg.max_retries), ka_period=i32(cfg.ka_period),
            )
        self.faulted = torch.zeros(r, dtype=torch.bool, device=dev) if cfg.fault != "none" else None
        self._crash_rate, self._recover_rate = f32(cfg.crash_rate), f32(cfg.recover_rate)
        self._slow_factor = f32(cfg.slow_factor)
        self.active_rem = torch.zeros((r, s), dtype=torch.int64, device=dev)
        self.active_rid = torch.full((r, s), -1, dtype=torch.int64, device=dev)
        # The slot each active request was admitted in (its start).
        self._active_start = torch.full((r, s), -1, dtype=torch.int64, device=dev)
        self._qcap = queue_cap
        self._q_rid = torch.full((r, queue_cap), -1, dtype=torch.int64, device=dev)
        self._q_head = torch.zeros(r, dtype=torch.int64, device=dev)
        self._q_len = torch.zeros(r, dtype=torch.int64, device=dev)
        self.approx = torch.zeros(r, dtype=_F32, device=dev)  # emulated occupancy
        self.comm = comm_lib.CommState.init(r, device=dev)
        self.total_completions = 0
        self.rng = rng if rng is not None else np.random.default_rng(seed)
        self._rr_ptr = 0  # round-robin pointer ("rr" policy)
        self.last_subset: Optional[torch.Tensor] = None  # "sqd" diagnostics
        # Pull-policy token pool, refreshed on token-message delivery;
        # token_misses counts routed arrivals that found it empty,
        # token_sum integrates its end-of-slot occupancy.
        self._tokens = (torch.zeros(r, dtype=_I32, device=dev)
                        if cfg.policy in PULL_POLICIES else None)
        self._token_x = f32(self._ccfg.x)
        self.token_misses = 0
        self._token_sum = torch.zeros((), dtype=torch.int64, device=dev)
        # float32 drain and drain-score vectors, the same IEEE products as
        # the fixed-horizon engine's.
        if cfg.decode_rates is None:
            self._rates = None
            rates_f32 = torch.ones(r, dtype=_F32, device=dev)
        else:
            self._rates = torch.tensor(np.asarray(cfg.decode_rates, np.float32), device=dev)
            rates_f32 = self._rates
        self._drainv = f32(cfg.msr_drain) * rates_f32
        self._drain_slots = routing_lib.expected_drain_slots(
            f32(cfg.mean_prefill) + f32(cfg.mean_decode), rates_f32)
        self._replica = torch.arange(r, dtype=torch.int64, device=dev)
        # rid-indexed work (grown on demand), the request objects, and the
        # float32 slot clock of the decode-rate credit schedule.
        self._work = torch.zeros(1024, dtype=torch.int64, device=dev)
        self._store: dict[int, Request] = {}
        self._clock = torch.arange(1024, dtype=_F32, device=dev)

    @property
    def messages(self) -> int:
        return int(self.comm.msgs)

    @property
    def token_sum(self) -> int:
        return int(self._token_sum)

    def true_occupancy(self) -> torch.Tensor:
        """Exact per-replica occupancy (queued + active), int64 ``(R,)``."""
        return self._q_len + (self.active_rem > 0).sum(1)

    def _ensure_rid(self, rid: int):
        while rid >= self._work.shape[0]:
            self._work = torch.cat([self._work, torch.zeros_like(self._work)])

    def _grow_queues(self):
        """Double the rings, each linearised from its head into the new one."""
        cap = self._qcap
        pos = torch.arange(cap, dtype=torch.int64, device=self.device)
        lin = self._q_rid.gather(1, torch.remainder(self._q_head[:, None] + pos, cap))
        new = torch.full((self.cfg.num_replicas, 2 * cap), -1, dtype=torch.int64,
                         device=self.device)
        new[:, :cap] = torch.where(pos[None, :] < self._q_len[:, None], lin, -1)
        self._q_rid, self._q_head, self._qcap = new, torch.zeros_like(self._q_head), 2 * cap

    def _healthy(self) -> Optional[torch.Tensor]:
        """The suspect mask: replicas whose last update is within
        ``suspect_age`` (the last-heard clock and ``gave_up`` under ack, the
        wire's age under a network, else the trigger's slots since a
        message); all-suspect degrades to all healthy.  None when off."""
        cfg = self.cfg
        if cfg.suspect_age <= 0:
            return None
        if self.net is not None and cfg.transport == "ack":
            healthy = (self.net.ka_age <= cfg.suspect_age) & ~self.net.gave_up
        else:
            age = self.net.age if self.net is not None else self.comm.slots_since_msg
            healthy = age <= cfg.suspect_age
        return torch.where(healthy.any(), healthy, True)

    def route(self, req: Request, now: int, u: Optional[float] = None,
              sub_u=None) -> int:
        cfg = self.cfg
        r_n = cfg.num_replicas
        occ = self.true_occupancy().to(_F32) if cfg.comm == "exact" else self.approx
        self.last_subset = None
        healthy = self._healthy()
        if cfg.policy == "rr" and healthy is None:
            j = torch.full((1,), self._rr_ptr % r_n, dtype=torch.int64, device=self.device)
            self._rr_ptr += 1
        elif cfg.policy == "rr":
            # Masked round robin: the cyclically next healthy replica.
            off = torch.remainder(self._replica - self._rr_ptr, r_n)
            j = torch.argmin(torch.where(healthy, off, r_n))
        else:
            if u is None:
                u = self.rng.random(dtype=np.float32)
            det = cfg.deterministic_ties
            if cfg.policy == "sqd":
                if sub_u is None:
                    sub_u = self.rng.random(size=SQD_MAX, dtype=np.float32)
                mask = subset_mask(torch.from_numpy(np.asarray(sub_u, np.float32)),
                                   r_n, cfg.sqd)
                self.last_subset = mask
                mask = mask.to(self.device)
                if healthy is not None:
                    both = mask & healthy
                    mask = torch.where(both.any(), both, mask)
                j = _pick_min_tied(occ, float(u), mask, det)
            elif cfg.policy == "drain":
                j = _pick_min_tied(occ * self._drain_slots, float(u), healthy, det)
            elif cfg.policy in PULL_POLICIES:
                # Spend a token at the replica holding the most (an empty
                # pool is an all-tie: the uniform fallback).
                j = _pick_min_tied((0 - self._tokens).to(_F32), float(u), healthy, det)
            else:  # jsaq
                j = _pick_min_tied(occ, float(u), healthy, det)
        j = j.reshape(1)
        vals = [j, self._q_len.index_select(0, j), self._q_head.index_select(0, j)]
        if self._tokens is not None:
            vals.append(self._tokens.index_select(0, j).to(torch.int64))
        # The one synchronisation of a route.
        got = torch.cat(vals).tolist()
        j, q_len, q_head = got[:3]
        if cfg.policy == "rr" and healthy is not None:
            self._rr_ptr = j + 1
        if self._tokens is not None:
            if got[3] == 0:
                self.token_misses += 1
            self._tokens[j] = max(got[3] - 1, 0)
        if cfg.policy == "sqd" and self.net is not None:
            # SQ(d)'s d queries and d replies on the wire.
            self.comm = dataclasses.replace(self.comm, msgs=self.comm.msgs + 2 * cfg.sqd)
        if q_len >= self._qcap:
            self._grow_queues()
            q_head = 0
        self._ensure_rid(req.rid)
        # A zero-work request still takes a decode slot for one iteration.
        self._work[req.rid] = max(req.prefill_cost + req.decode_len, 1)
        self._store[req.rid] = req
        self._q_rid[j, (q_head + q_len) % self._qcap] = req.rid
        self._q_len[j] += 1
        self.approx[j] += 1  # arrival known to the dispatcher (Eq. 10)
        return j

    def _row(self, x) -> torch.Tensor:
        """A slot's uniforms (array or tensor) as float32 on the device."""
        if torch.is_tensor(x):
            return x.to(device=self.device, dtype=_F32)
        return torch.from_numpy(np.asarray(x, np.float32)).to(self.device)

    def step(self, now: int, drop_u=None, jit_u=None, fault_u=None,
             ack_u=None) -> list[Request]:
        cfg = self.cfg
        while now >= self._clock.shape[0]:
            self._clock = torch.arange(2 * self._clock.shape[0], dtype=_F32,
                                       device=self.device)
        slot_f = self._clock[now]

        # 0. faults advance before admission (arrivals were routed against
        # the previous slot's state).
        recovered = None
        if self.faulted is not None:
            if fault_u is None:
                raise ValueError(
                    "step() needs this slot's fault_u row when "
                    f"fault={cfg.fault!r} (sample_workload with_fault=True)"
                )
            self.faulted, recovered = workload_lib.fault_transitions(
                self.faulted, self._row(fault_u), self._crash_rate, self._recover_rate)

        # 1. admit: fill free decode slots from the rings, FIFO; a crashed
        # replica is frozen (its queue waits).  free_rank is -1 on busy
        # slots: the floor mod keeps the ring index valid.
        free = self.active_rem <= 0
        free_rank = free.cumsum(1) - 1
        n_admit = torch.minimum(self._q_len, free.sum(1))
        if cfg.fault == "crash":
            n_admit = torch.where(self.faulted, 0, n_admit)
        take = free & (free_rank < n_admit[:, None])
        rid = self._q_rid.gather(1, torch.remainder(self._q_head[:, None] + free_rank,
                                                    self._qcap))
        self.active_rid = torch.where(take, rid, self.active_rid)
        self.active_rem = torch.where(take, self._work[rid.clamp_min(0)], self.active_rem)
        self._active_start = torch.where(take, now, self._active_start)
        self._q_head = torch.remainder(self._q_head + n_admit, self._qcap)
        self._q_len = self._q_len - n_admit

        # 2. service: one decode iteration on every active slot (or the
        # slot's credit-schedule units); rem may go negative == free.
        active = self.active_rem > 0
        if self.faulted is not None:
            nominal = 1 if self._rates is None else workload_lib.service_units(
                slot_f, self._rates)
            units = workload_lib.faulted_service_units(
                slot_f, self.faulted, nominal, cfg.fault, self._slow_factor,
                rates=self._rates)
            self.active_rem = self.active_rem - units[:, None] * active
        elif self._rates is None:
            self.active_rem = self.active_rem - active.to(torch.int64)
        else:
            units = workload_lib.service_units(slot_f, self._rates)
            self.active_rem = self.active_rem - units[:, None] * active
        done = active & (self.active_rem <= 0)
        completions = done.sum(1, dtype=_I32)
        # One copy a slot: the finished rids and their start slots, in
        # (replica, decode slot) order.
        fin = torch.stack([torch.where(done, self.active_rid, -1),
                           self._active_start]).cpu().numpy().reshape(2, -1)
        finished: list[Request] = []
        for rid_done, start in zip(*fin[:, fin[0] >= 0]):
            req = self._store.pop(int(rid_done))
            req.started = int(start)
            req.finished = now
            finished.append(req)
        self.active_rid = torch.where(done, -1, self.active_rid)
        self.total_completions += len(finished)

        # 3. MSR drain at the nominal rate, per replica (float32).
        busy = self.approx > 0
        self.approx = torch.clamp_min(self.approx - self._drainv * busy.to(_F32), 0.0)

        # 4. trigger (shared core): a crashed replica cannot send and a
        # recovery forces a resync; under a network the trigger is an
        # intent and the wire bills the messages.
        true_occ = self.true_occupancy().to(_F32)
        err = (true_occ - self.approx).abs()
        can_send = force = None
        if cfg.fault == "crash":
            can_send, force = ~self.faulted, recovered
        trig, self.comm = comm_lib.evaluate(
            self.comm, self._ccfg, err, completions, can_send=can_send, force=force,
            q=true_occ, count_msgs=self.net is None,
        )
        # 5. the wire: the dispatcher's view advances on *delivery* of the
        # send-time snapshot.
        if self.net is not None:
            if drop_u is None or jit_u is None:
                raise ValueError(
                    "step() needs this slot's drop_u/jit_u rows when "
                    f"network={cfg.network!r} (sample_workload with_net=True)"
                )
            if cfg.transport == "ack":
                if ack_u is None:
                    raise ValueError(
                        "step() needs this slot's ack_u rows when "
                        "transport='ack' (sample_workload with_ack=True)"
                    )
                delivered, payload, sent, self.net = comm_lib.net_step_ack(
                    self.net, self._ncfg, trig, true_occ, self._row(drop_u),
                    self._row(jit_u), self._row(ack_u), can_send=can_send)
            else:
                delivered, payload, sent, self.net = comm_lib.net_step(
                    self.net, self._ncfg, trig, true_occ, self._row(drop_u),
                    self._row(jit_u), can_send=can_send)
            self.comm = dataclasses.replace(self.comm, msgs=self.comm.msgs + sent)
            snap_mask, snap = delivered, payload
        else:
            snap_mask, snap = trig, true_occ
        self.approx = torch.where(snap_mask, snap, self.approx)
        # 6. pull tokens: a delivered token message overwrites its replica's
        # pool entry from the send-time snapshot (1 if idle for jiq, the
        # headroom below x truncated to int32 for hsq).
        if self._tokens is not None:
            if cfg.comm == "jiq":
                fresh = (snap == 0.0).to(_I32)
            else:
                fresh = torch.clamp_min(self._token_x - snap, 0.0).to(_I32)
            self._tokens = torch.where(snap_mask, fresh, self._tokens)
            self._token_sum = self._token_sum + self._tokens.sum()
        return finished


def run_serving_sim(
    cfg: EngineConfig,
    *,
    slots: int = 20_000,
    load: float = 0.9,
    mean_decode: int = 64,
    mean_prefill: int = 4,
    seed: int = 0,
    model_fn=None,
    workload=None,
    checkpoints: Sequence[int] = (),
    device: str | torch.device | None = None,
) -> dict:
    """Drive :class:`CareDispatcher` with a pre-sampled workload; return metrics.

    The workload is :func:`sample_workload`'s unless ``workload`` is given
    (a port :class:`ServeWorkload`, or any object with its fields, such as
    the reference's, copied by :meth:`ServeWorkload.from_arrays`).  Each
    slot routes its arrivals, steps the dispatcher, snapshots the exact
    occupancy if the slot is in ``checkpoints`` (``out["occupancy"][slot]``,
    end of slot), then calls ``model_fn(now)``.  ``mean_prefill`` /
    ``mean_decode`` replace the config's, so the drain policy's ``E[S]`` is
    the one the workload was sampled with.  ``device=None`` means the CUDA
    card.
    """
    with_net = cfg.network != "none"
    with_fault = cfg.fault != "none"
    with_ack = with_net and cfg.transport == "ack"
    if workload is None:
        workload = sample_workload(
            seed, replicas=cfg.num_replicas, decode_slots=cfg.decode_slots,
            slots=slots, load=load, mean_prefill=mean_prefill,
            mean_decode=mean_decode, rate_scale=mean_decode_rate(cfg.decode_rates),
            with_net=with_net, with_fault=with_fault, with_ack=with_ack,
        )
    elif not isinstance(workload, ServeWorkload):
        workload = ServeWorkload.from_arrays(workload)
    for needed, name, flag in ((with_net, "net_drop_u", "with_net"),
                               (with_fault, "fault_u", "with_fault"),
                               (with_ack, "ack_u", "with_ack")):
        if needed and getattr(workload, name) is None:
            raise ValueError(
                f"workload lacks the {name} stream; sample it with {flag}=True"
            )
    cfg = dataclasses.replace(
        cfg, mean_prefill=float(mean_prefill), mean_decode=float(mean_decode)
    )
    disp = CareDispatcher(cfg, seed, device=device)
    # The control plane's uniforms go to the device once; each slot reads
    # its row.
    streams = {}
    for name, on in (("net_drop_u", with_net), ("net_jit_u", with_net),
                     ("fault_u", with_fault), ("ack_u", with_ack)):
        if on:
            streams[name] = torch.from_numpy(np.asarray(getattr(workload, name),
                                                        np.float32)).to(disp.device)

    def row(name, now):
        return streams[name][now] if name in streams else None

    finished: list[Request] = []
    occupancy: dict[int, torch.Tensor] = {}
    want_ckpt = set(int(c) for c in checkpoints)
    n_arr, base = workload.n_arr.tolist(), workload.base.tolist()
    prefill, decode = workload.prefill, workload.decode
    for now in range(slots):
        for rid in range(base[now], base[now] + n_arr[now]):
            req = Request(rid=rid, arrival=now, prefill_cost=int(prefill[rid]),
                          decode_len=int(decode[rid]))
            disp.route(req, now, u=float(workload.tie_u[rid]), sub_u=workload.sub_u[rid])
        finished.extend(disp.step(
            now, drop_u=row("net_drop_u", now), jit_u=row("net_jit_u", now),
            fault_u=row("fault_u", now), ack_u=row("ack_u", now),
        ))
        if now in want_ckpt:
            occupancy[now] = disp.true_occupancy().clone()
        if model_fn is not None:
            model_fn(now)

    # JCT vector in rid (arrival) order, as the fixed-horizon engine emits it.
    jct_by_rid = np.full(workload.total, -1, np.int64)
    for r in finished:
        jct_by_rid[r.rid] = r.finished - r.arrival + 1
    jct = jct_by_rid[jct_by_rid >= 0]
    messages = disp.messages
    return {
        "jct": jct,
        "jct_by_rid": jct_by_rid,
        "mean_jct": float(jct.mean()) if jct.size else 0.0,
        "p99_jct": float(np.percentile(jct, 99)) if jct.size else 0.0,
        "completed": len(finished),
        "offered": workload.total,
        "messages": messages,
        "msgs_per_completion": messages / max(disp.total_completions, 1),
        "final_occupancy": disp.true_occupancy().cpu().numpy(),
        "occupancy": {t: o.cpu().numpy() for t, o in occupancy.items()},
        "requests": finished,
        "net_drops": int(disp.net.drops) if disp.net is not None else 0,
        "retrans": int(disp.net.retrans) if with_ack else 0,
        "token_misses": int(disp.token_misses),
        "token_sum": disp.token_sum,
    }


# ---------------------------------------------------------------------------
# The engine: one Python loop over slots, all runs at once.
# ---------------------------------------------------------------------------


def _route_lanes(static, act, n_arr_t, tie_t, sub_t, q_len, q_head, busy_cnt,
                 approx, rr_ptr, dropped, drain_slots, healthy=None, pull=None,
                 suspect=None):
    """The dense backend: the reference's per-lane body, one lane per step.

    Every routed request bumps ``q_len`` / ``approx`` before the next lane
    reads them.  ``healthy`` ``(D, R)`` (or None) masks suspect replicas
    out; ``pull`` is the ``(tokens, token_miss)`` pair of the pull
    policies, which spend a token a routed request; ``suspect`` is the
    ``(masked_routes, suspect_routes)`` pair counting, under a mask with
    some but not all replicas suspect, the routed requests and those that
    went to a suspect replica.  Returns ``(jv, tail, admit, q_len',
    approx', rr_ptr', dropped', pull', suspect')`` with ``(D, A)`` lane
    outputs.
    """
    r_n, c_n = static.replicas, static.queue_cap
    rep_idx = torch.arange(r_n, dtype=_I32, device=q_len.device)
    partial = None
    if healthy is not None:
        partial = healthy.any(1) & ~healthy.all(1)
    jvs, tails, admits = [], [], []
    for a in range(tie_t.shape[1]):
        live = act & (a < n_arr_t)
        if static.comm == "exact":
            occ = (q_len + busy_cnt).to(_F32)
        else:
            occ = approx
        if static.policy == "rr" and healthy is None:
            # The pointer advances only on live lanes.
            j = torch.remainder(rr_ptr, r_n)
            rr_ptr = rr_ptr + live.to(_I32)
        elif static.policy == "rr":
            # Skip suspect replicas to the cyclically next healthy one.
            off = torch.remainder(rep_idx - rr_ptr[:, None], r_n)
            j = torch.argmin(torch.where(healthy, off, r_n), 1).to(_I32)
            rr_ptr = torch.where(live, j + 1, rr_ptr)
        else:
            if static.policy in PULL_POLICIES:
                score = (0 - pull[0]).to(_F32)
            elif static.policy == "drain":
                score = occ * drain_slots
            else:
                score = occ
            if static.policy == "sqd":
                cand = subset_mask(sub_t[:, a], r_n, static.sqd)
                if healthy is not None:
                    # Suspects leave the sampled subset unless all of it is.
                    both = cand & healthy
                    cand = torch.where(both.any(1, keepdim=True), both, cand)
                score = torch.where(cand, score, torch.inf)
            elif healthy is not None:
                score = torch.where(healthy, score, torch.inf)
            if static.deterministic_ties:
                j = torch.argmin(score, 1)
            else:
                is_min = score == score.amin(1, keepdim=True)
                n_ties = is_min.sum(1, dtype=_I32)
                rank = torch.minimum((tie_t[:, a] * n_ties.to(_F32)).to(_I32), n_ties - 1)
                cum = is_min.cumsum(1, dtype=_I32)
                j = torch.argmax((cum == (rank + 1)[:, None]).to(_I32), 1)
        j = j.long()
        onehot = rep_idx == j[:, None]
        if pull is not None:
            # Spend the routed replica's token; an empty pool is a miss.
            tokens, token_miss = pull
            token_miss = token_miss + (live & (tokens.gather(1, j[:, None])[:, 0] == 0)).to(_I32)
            pull = (torch.clamp_min(tokens - (onehot & live[:, None]).to(_I32), 0), token_miss)
        if partial is not None:
            routed = live & partial
            hit = routed & ~healthy.gather(1, j[:, None])[:, 0]
            suspect = (suspect[0] + routed.to(_I32), suspect[1] + hit.to(_I32))
        len_j = q_len.gather(1, j[:, None])[:, 0]
        # The ring is fixed: a full ring drops the arrival (counted).
        admit = live & (len_j < c_n)
        tail = torch.remainder(q_head.gather(1, j[:, None])[:, 0] + len_j, c_n)
        sel = onehot & admit[:, None]
        q_len = q_len + sel.to(_I32)
        approx = approx + sel.to(_F32)
        dropped = dropped + (live & ~admit).to(_I32)
        jvs.append(j.to(_I32))
        tails.append(tail)
        admits.append(admit)
    return (torch.stack(jvs, 1), torch.stack(tails, 1), torch.stack(admits, 1),
            q_len, approx, rr_ptr, dropped, pull, suspect)


@dataclasses.dataclass
class StreamMetrics:
    """The streaming JCT accumulators, one row per run (stream mode's
    ``EngineCarry.comp_slot``).

    ``count`` / ``mean`` / ``m2`` are the Welford running count, mean and
    sum of squared deviations of the measured (post-warmup) JCTs, combined
    slot by slot with Chan's batch rule in float32, so that no chunking can
    change them; ``max_jct`` is the exact maximum and ``hist`` the
    :func:`repro_torch.core.care.metrics.jct_bucket` histogram, the source
    of tail quantiles.  Messages and drops stay where the fixed horizon
    keeps them (``CommState.msgs``, ``NetState.drops``).
    """

    count: torch.Tensor  # (D,) int32 measured completions
    mean: torch.Tensor  # (D,) float32
    m2: torch.Tensor  # (D,) float32
    max_jct: torch.Tensor  # (D,) int32
    hist: torch.Tensor  # (D, HIST_BUCKETS) int32

    COUNTERS = ("count",)  # running totals (see comm.snapshot_state)

    @staticmethod
    def init(d: int, device=None) -> "StreamMetrics":
        def zeros(*shape, dtype=_I32):
            return torch.zeros(shape, dtype=dtype, device=device)

        return StreamMetrics(count=zeros(d), mean=zeros(d, dtype=_F32),
                             m2=zeros(d, dtype=_F32), max_jct=zeros(d),
                             hist=zeros(d, metrics_lib.HIST_BUCKETS))

    def update(self, jct: torch.Tensor, meas: torch.Tensor) -> "StreamMetrics":
        """Fold one slot's completions in: ``jct`` int32 and ``meas`` bool
        (the measured ones), ``(D, ...)`` each.

        Chan's combine in the reference's order of float32 operations: the
        batch mean, the batch's squared deviations from it, then the
        running mean and m2.  A run with no measured completion is left as
        it was, every field.
        """
        d = jct.shape[0]
        jct, meas = jct.reshape(d, -1), meas.reshape(d, -1)
        n_b = meas.sum(1, dtype=_I32)
        has = n_b > 0
        jf = jct.to(_F32)
        n_bf = n_b.to(_F32)
        mean_b = torch.where(meas, jf, 0.0).sum(1) / torch.clamp_min(n_bf, 1.0)
        dv = jf - mean_b[:, None]
        m2_b = torch.where(meas, dv * dv, 0.0).sum(1)
        n_af = self.count.to(_F32)
        tot = torch.clamp_min(n_af + n_bf, 1.0)
        delta = mean_b - self.mean
        mean = torch.where(has, self.mean + delta * n_bf / tot, self.mean)
        m2 = torch.where(has, self.m2 + m2_b + delta * delta * n_af * n_bf / tot, self.m2)
        # Unmeasured entries go to the trash bucket HIST_BUCKETS (the
        # reference's out-of-bounds mode="drop").
        bucket = torch.where(meas, metrics_lib.jct_bucket(jct), metrics_lib.HIST_BUCKETS)
        add = torch.zeros((d, metrics_lib.HIST_BUCKETS + 1), dtype=_I32, device=jct.device)
        add.scatter_add_(1, bucket.long(), torch.ones_like(bucket))
        return StreamMetrics(
            count=self.count + n_b, mean=mean, m2=m2,
            max_jct=torch.maximum(self.max_jct, torch.where(meas, jct, 0).amax(1)),
            hist=self.hist + add[:, :metrics_lib.HIST_BUCKETS],
        )


@dataclasses.dataclass
class EngineCarry:
    """The engine's state between slots, one row per run: what a chunk of
    :func:`serve_stream` resumes from (the reference's scan carry).

    ``q_work`` / ``q_rid`` ``(D, R, C)`` are the pending rings (``q_rid``
    holds request ids, in stream mode arrival slots), ``rem`` / ``arid``
    ``(D, R, S)`` the decode slots' remaining work and request (arrival
    slot), ``comp_slot`` the rid-indexed completion slots ``(D, n_cap)`` or,
    in stream mode, the :class:`StreamMetrics`.  ``net`` / ``faulted`` are
    None when their kinds are off, ``pull`` the ``(tokens, token_miss,
    token_sum)`` pool of the pull policies (else None) and ``suspect`` the
    ``(masked_routes, suspect_routes)`` counters.
    """

    q_len: torch.Tensor
    q_head: torch.Tensor
    q_work: torch.Tensor
    q_rid: torch.Tensor
    rem: torch.Tensor
    arid: torch.Tensor
    approx: torch.Tensor
    comm: comm_lib.CommState
    rr_ptr: torch.Tensor
    comp_slot: object
    total_comp: torch.Tensor
    dropped: torch.Tensor
    net: object
    faulted: Optional[torch.Tensor]
    pull: Optional[tuple]
    suspect: tuple

    COUNTERS = ("total_comp", "dropped")  # running totals (see comm.snapshot_state)


def _engine_init(static: EngineStatic, n_cap: int, d: int, device) -> EngineCarry:
    """The carry of ``d`` runs at slot 0 (both modes; ``n_cap`` sizes the
    fixed horizon's ``comp_slot``)."""
    r_n, s_n, c_n = static.replicas, static.decode_slots, static.queue_cap

    def zeros(*shape, dtype=_I32):
        return torch.zeros(shape, dtype=dtype, device=device)

    def minus_one(*shape):
        return torch.full(shape, -1, dtype=_I32, device=device)

    comm, net, faulted = comm_lib.control_plane_init(
        r_n, network=static.network, fault=static.fault, transport=static.transport,
        batch=(d,), device=device, payload_dtype=_F32,
    )
    return EngineCarry(
        q_len=zeros(d, r_n), q_head=zeros(d, r_n), q_work=zeros(d, r_n, c_n),
        q_rid=minus_one(d, r_n, c_n), rem=zeros(d, r_n, s_n),
        arid=minus_one(d, r_n, s_n), approx=zeros(d, r_n, dtype=_F32), comm=comm,
        rr_ptr=zeros(d),
        comp_slot=StreamMetrics.init(d, device) if static.stream else minus_one(d, n_cap),
        total_comp=zeros(d), dropped=zeros(d), net=net, faulted=faulted,
        pull=(zeros(d, r_n), zeros(d), zeros(d)) if static.policy in PULL_POLICIES else None,
        suspect=(zeros(d), zeros(d)),
    )


class _CoreArgs(NamedTuple):
    """The arguments of :func:`_serve_core`, by name (see there)."""

    n_arr: torch.Tensor
    work: torch.Tensor
    tie_u: torch.Tensor
    rid: torch.Tensor
    sub_u: torch.Tensor
    scn: EngineScenario
    static: EngineStatic
    n_cap: int
    t_end: int
    live_lanes: np.ndarray
    control: Optional[dict] = None
    carry: Optional[EngineCarry] = None
    t0: int = 0


# Counters of the degraded control plane and the pull policies in
# _serve_core's dict (zero where their kinds are off).
CONTROL_COUNTERS = ("net_drops", "retrans", "token_misses", "token_sum",
                    "masked_routes", "suspect_routes")

# The carry fields serve_slots resumes from and writes back, by the names
# of ops.serve_slots' carry dict.
_SLOTS_STATE = ("q_len", "q_head", "q_work", "q_rid", "rem", "arid", "approx",
                "total_comp", "dropped")
_SLOTS_METRICS = ("count", "mean", "m2", "max_jct", "hist")


def _slots_view(carry: EngineCarry) -> dict:
    """The fields of a stream carry that ``serve_slots`` carries, flat (the
    tensors themselves, which the kernel updates in place)."""
    view = {name: getattr(carry, name) for name in _SLOTS_STATE}
    view.update(deps_since_msg=carry.comm.deps_since_msg,
                slots_since_msg=carry.comm.slots_since_msg, msgs=carry.comm.msgs)
    view.update({name: getattr(carry.comp_slot, name) for name in _SLOTS_METRICS})
    return view


def _from_slots_view(carry: EngineCarry, view: dict) -> EngineCarry:
    """``carry`` with the fields of :func:`_slots_view` taken from ``view``."""
    return dataclasses.replace(
        carry, **{name: view[name] for name in _SLOTS_STATE},
        comm=comm_lib.CommState(view["deps_since_msg"], view["slots_since_msg"],
                                view["msgs"]),
        comp_slot=StreamMetrics(**{name: view[name] for name in _SLOTS_METRICS}),
    )


def _serve_core(n_arr, work, tie_u, rid, sub_u, scn: EngineScenario,
                static: EngineStatic, n_cap: int, t_end: int,
                live_lanes: np.ndarray, control: Optional[dict] = None,
                carry: Optional[EngineCarry] = None, t0: int = 0):
    """The port of ``_serve_core``: slots ``[t0, t0 + t_end)`` of every run.

    Args:
      n_arr: ``(T, D)`` int32 arrivals per slot and run.
      work / tie_u / rid: ``(T, D, A)`` arrival lanes (int32 / float32 /
        int32); lanes ``>= n_arr`` are masked no-ops.  Stream mode reads no
        ``rid``: a request's ring entry is its arrival slot.
      sub_u: ``(T, D, A, sqd)`` float32 subset uniforms (``sqd = 0`` unless
        the policy is ``"sqd"``).
      scn: the runs' stacked scenario, on the same device.
      n_cap: capacity of the rid-indexed completion-slot array (fixed mode).
      t_end: the slots to run; every run is frozen from its horizon on.
      live_lanes: ``(T,)`` host-side count of lanes live in some run; the
        dense backend routes only those (a dead lane changes nothing).
      control: the control plane's float32 uniforms, present when their
        kinds are on: ``net_drop_u`` / ``net_jit_u`` / ``fault_u`` ``(T,
        D, R)`` and ``ack_u`` ``(T, D, 4, R)``.
      carry: the :class:`EngineCarry` to resume from (None: slot 0's).
      t0: the absolute slot of the first slot (the slot clock of horizons,
        decode rates, JCTs and the warmup gate).

    The fused backend goes through :func:`repro_torch.kernels.ops.serve_slots`:
    on the card all ``t_end`` slots are one ``serve_slots`` launch, on the
    CPU its plain version, the per-slot loop :func:`_serve_loop`.  The dense
    backend always runs that loop.

    In stream mode (``static.stream``) returns the advanced carry; on the
    card the fused backend advances ``carry`` in place (a carry resumes
    once).  Otherwise returns a dict of ``(D, ...)`` tensors:
    ``comp_slot`` ``(D, n_cap)``, ``msgs``, ``total_comp``, ``dropped``
    ``(D,)``, ``final_occ`` ``(D, R)``, under ``trace_occupancy``
    ``occupancy`` ``(D, T, R)`` (else None), the end-of-run routing state
    ``q_len``, ``q_head``, ``approx`` and the busy decode-slot count
    ``busy`` ``(D, R)``, and the ``(D,)`` counters of
    :data:`CONTROL_COUNTERS` (see :func:`_route_lanes` for the last two).
    """
    args = _CoreArgs(n_arr, work, tie_u, rid, sub_u, scn, static, n_cap, t_end,
                     live_lanes, control, carry, t0)
    if static.route_backend != "fused":
        carry, occ = _serve_loop(args)
        return carry if static.stream else _fixed_outputs(carry, occ)
    kw = dict(cap=static.queue_cap, comm=static.comm, decode_slots=static.decode_slots,
              use_rates=static.use_rates, trace_occupancy=static.trace_occupancy,
              n_cap=n_cap, t_end=t_end)
    slot_args = (n_arr, work, rid, scn.x, scn.rt_period, scn.msr_drain,
                 scn.decode_rates, scn.horizon)
    if static.stream:
        if carry is None:
            carry = _engine_init(static, n_cap, work.shape[1], work.device)
            args = args._replace(carry=carry)
        view = kernel_ops.serve_slots(
            *slot_args, **kw, carry=_slots_view(carry), t0=t0, warmup=scn.warmup,
            plain=lambda: _slots_view(_serve_loop(args)[0]),
        )
        return _from_slots_view(carry, view)
    if carry is not None or t0:
        raise ValueError("the fused fixed horizon starts at slot 0 from an empty "
                         "engine; resume a carry in stream mode")
    out = kernel_ops.serve_slots(
        *slot_args, **kw, plain=lambda: _fixed_outputs(*_serve_loop(args)),
    )
    for name in CONTROL_COUNTERS:
        out.setdefault(name, torch.zeros_like(out["msgs"]))
    return out


def _fixed_outputs(carry: EngineCarry, occ_trace) -> dict:
    """:func:`_serve_core`'s dict of the fixed horizon from the final carry."""
    busy = (carry.rem > 0).sum(2, dtype=_I32)
    zero = torch.zeros_like(carry.total_comp)
    net, pull = carry.net, carry.pull
    return dict(
        comp_slot=carry.comp_slot, msgs=carry.comm.msgs,
        total_comp=carry.total_comp, dropped=carry.dropped,
        final_occ=carry.q_len + busy, occupancy=occ_trace, q_len=carry.q_len,
        q_head=carry.q_head, approx=carry.approx, busy=busy,
        net_drops=zero if net is None else net.drops,
        retrans=net.retrans if isinstance(net, comm_lib.AckNetState) else zero,
        token_misses=zero if pull is None else pull[1],
        token_sum=zero if pull is None else pull[2],
        masked_routes=carry.suspect[0], suspect_routes=carry.suspect[1],
    )


def _serve_loop(args: _CoreArgs) -> tuple:
    """:func:`_serve_core` as a Python loop over slots: ``(carry',
    occupancy)``, the trace None unless ``trace_occupancy``.

    Slot ``t`` reads the slot-``t`` views of the inputs and keeps every
    counter on the device, so nothing waits for the card inside the loop.
    The fused backend routes each slot with one
    :func:`repro_torch.kernels.ops.serve_route` call for all runs.  Inside
    the loop the rings ``(D, R+1, C)`` and ``comp_slot`` ``(D, n_cap+1)``
    carry one trash row / column, where the reference's out-of-bounds
    ``mode="drop"`` scatters land; the carry going in and out has none.
    """
    (n_arr, work, tie_u, rid, sub_u, scn, static, n_cap, t_end, live_lanes,
     control, carry, t0) = args
    control = control or {}
    t_n, d_n = work.shape[:2]
    r_n, c_n = static.replicas, static.queue_cap
    dev = work.device
    stream = static.stream
    ccfg = comm_lib.CommConfig(
        kind=static.comm, x=scn.x[:, None], rt_period=scn.rt_period[:, None]
    )
    has_net = static.network != "none"
    has_ack = has_net and static.transport == "ack"
    has_fault = static.fault != "none"
    has_pull = static.policy in PULL_POLICIES
    ncfg = comm_lib.NetworkConfig(
        static.network, delay=scn.net_delay[:, None], jitter=scn.net_jitter[:, None],
        drop=scn.net_drop[:, None], transport=static.transport,
        ack_timeout=scn.ack_timeout[:, None], backoff_base=scn.backoff_base[:, None],
        max_retries=scn.max_retries[:, None], ka_period=scn.ka_period[:, None],
    )
    suspect_age = scn.suspect_age[:, None]
    rates = scn.decode_rates  # (D, R)
    # msr_drain * 1.0 is exact, so unit rates cannot perturb the drain.
    drainv = scn.msr_drain[:, None] * rates
    drain_slots = None
    if static.policy == "drain":
        drain_slots = routing_lib.expected_drain_slots(
            (scn.mean_prefill + scn.mean_decode)[:, None], rates
        )
    # The absolute slot clock: horizons, decode credits, JCTs and warmup.
    clock = t0 + torch.arange(t_n, dtype=torch.int64, device=dev)
    active = clock[:, None] < scn.horizon[None, :]
    slot_f = clock.to(_F32)

    if carry is None:
        carry = _engine_init(static, n_cap, d_n, dev)
    trash = torch.full((d_n, 1, c_n), -1, dtype=_I32, device=dev)
    q_len, q_head, rem, arid, approx = (carry.q_len, carry.q_head, carry.rem,
                                        carry.arid, carry.approx)
    q_work = torch.cat([carry.q_work, torch.zeros_like(trash)], 1)
    q_rid = torch.cat([carry.q_rid, trash], 1)
    comm_state, net, faulted = carry.comm, carry.net, carry.faulted
    rr_ptr, total_comp, dropped = carry.rr_ptr, carry.total_comp, carry.dropped
    pull = carry.pull[:2] if has_pull else None
    token_sum = carry.pull[2] if has_pull else None
    suspect = carry.suspect
    if stream:
        metrics = carry.comp_slot
    else:
        comp_slot = torch.cat([carry.comp_slot, trash[:, 0, :1]], 1)
    occ_trace = (torch.zeros((d_n, t_n, r_n), dtype=_I32, device=dev)
                 if static.trace_occupancy else None)

    for t in range(t_end):
        tt = t0 + t
        act = active[t]
        act_r = act[:, None]
        # The dispatcher routes against the previous slot's replica state.
        busy_cnt = (rem > 0).sum(2, dtype=_I32)
        # Suspect mask from the staleness clock: the last-heard clock and
        # gave_up under ack, the wire's age under a network, else the
        # trigger's slots since a message; an all-suspect fleet routes to all.
        healthy = None
        if has_ack:
            off = suspect_age <= 0
            healthy = (off | (net.ka_age <= suspect_age)) & (off | ~net.gave_up)
        elif has_net or has_fault:
            age = net.age if has_net else comm_state.slots_since_msg
            healthy = (suspect_age <= 0) | (age <= suspect_age)
        if healthy is not None:
            healthy = torch.where(healthy.any(1, keepdim=True), healthy, True)

        # 1. route this slot's arrivals, one lane after the other.
        if static.route_backend == "fused":
            jv, tailv, admitv, q_len, approx, d_drop = kernel_ops.serve_route(
                tie_u[t], q_len, q_head, busy_cnt, approx, n_arr[t], act,
                cap=c_n, comm=static.comm,
            )
            dropped = dropped + d_drop
        else:
            k = max(int(live_lanes[t]), 1)
            (jv, tailv, admitv, q_len, approx, rr_ptr, dropped, pull,
             suspect) = _route_lanes(
                static, act, n_arr[t], tie_u[t, :, :k], sub_u[t, :, :k], q_len,
                q_head, busy_cnt, approx, rr_ptr, dropped, drain_slots,
                healthy=healthy, pull=pull, suspect=suspect,
            )
        # Admitted lanes never collide (successive admits to one replica
        # take successive tails); the others go to the trash row R.  The
        # scatters read the first jv.shape[1] lanes of work / rid; in stream
        # mode a request's entry is its arrival slot.
        ring_idx = (torch.where(admitv, jv, r_n) * c_n + tailv).long()
        q_work.view(d_n, -1).scatter_(1, ring_idx, work[t])
        if stream:
            q_rid.view(d_n, -1).scatter_(1, ring_idx, torch.full_like(jv, tt))
        else:
            q_rid.view(d_n, -1).scatter_(1, ring_idx, rid[t])

        # 1b. replica faults advance after routing, before admission.
        recovered = None
        if has_fault:
            adv_f, recovered = workload_lib.fault_transitions(
                faulted, control["fault_u"][t], scn.crash_rate[:, None],
                scn.recover_rate[:, None])
            faulted = torch.where(act_r, adv_f, faulted)
            recovered = recovered & act_r

        # 2. admit: fill free decode slots from the rings, FIFO (a crashed
        # replica admits nothing; its queue waits).
        free = rem <= 0
        free_rank = free.cumsum(2, dtype=_I32) - 1
        n_admit = torch.minimum(q_len, free.sum(2, dtype=_I32))
        n_admit = torch.where(act_r, n_admit, 0)
        if static.fault == "crash":
            n_admit = torch.where(faulted, 0, n_admit)
        take = free & (free_rank < n_admit[..., None])
        # free_rank is -1 on busy slots: the floor mod keeps the index valid.
        qidx = torch.remainder(q_head[..., None] + free_rank, c_n).long()
        rem = torch.where(take, q_work[:, :r_n].gather(2, qidx), rem)
        arid = torch.where(take, q_rid[:, :r_n].gather(2, qidx), arid)
        q_head = torch.remainder(q_head + n_admit, c_n)
        q_len = q_len - n_admit

        # 3. decode: one iteration (or the credit schedule's units) on
        # every active slot; rem may go negative, which means free.
        active_s = (rem > 0) & act[:, None, None]
        units = None
        if static.use_rates:
            units = workload_lib.service_units(slot_f[t], rates)
        if has_fault:
            units = workload_lib.faulted_service_units(
                slot_f[t], faulted, 1 if units is None else units, static.fault,
                scn.slow_factor[:, None], rates=rates if static.use_rates else None)
        if units is None:
            rem = rem - active_s.to(_I32)
        else:
            rem = rem - units[..., None] * active_s.to(_I32)
        done = active_s & (rem <= 0)
        completions = done.sum(2, dtype=_I32)
        if stream:
            # arid holds arrival slots: fold the JCTs of the completions
            # at or past the warmup slot into the accumulators.
            metrics = metrics.update(tt - arid + 1, done & (scn.warmup <= tt)[:, None, None])
        else:
            # A request completes once, so writing t is the reference's
            # scatter-max; slots that did not complete write the trash column.
            comp_idx = torch.where(done, arid, n_cap).reshape(d_n, -1).long()
            comp_slot.scatter_(1, comp_idx, tt)
        arid = torch.where(done, -1, arid)
        total_comp = total_comp + completions.sum(1, dtype=_I32)

        # 4. MSR drain, per replica and decode-rate scaled.
        busy = (approx > 0) & act_r
        approx = torch.clamp_min(approx - drainv * busy.to(_F32), 0.0)

        # 5. trigger (shared core), frozen past the horizon.  A crashed
        # replica cannot send and a recovery forces a resync; under a
        # network the trigger is an intent and the wire bills the messages.
        true_occ = (q_len + (rem > 0).sum(2, dtype=_I32)).to(_F32)
        err = (true_occ - approx).abs()
        can_send = force = None
        if static.fault == "crash":
            can_send, force = ~faulted, recovered
        trig, adv = comm_lib.evaluate(
            comm_state, ccfg, err, completions, can_send=can_send, force=force,
            q=true_occ, count_msgs=not has_net,
        )
        trig = trig & act_r
        snap_mask, snap_payload = trig, true_occ
        if has_net:
            # 6. network delivery (delay / jitter / drop, piggyback).
            if has_ack:
                delivered, payload, sent, net_adv = comm_lib.net_step_ack(
                    net, ncfg, trig, true_occ, control["net_drop_u"][t],
                    control["net_jit_u"][t], control["ack_u"][t], can_send=can_send)
            else:
                delivered, payload, sent, net_adv = comm_lib.net_step(
                    net, ncfg, trig, true_occ, control["net_drop_u"][t],
                    control["net_jit_u"][t], can_send=can_send)
            snap_mask, snap_payload = delivered & act_r, payload
            extra = torch.where(act, sent, 0)
            if static.policy == "sqd":
                # SQ(d)'s d queries and d replies a routed request.
                n_live = torch.clamp_max(n_arr[t], work.shape[2])
                extra = extra + torch.where(act, 2 * static.sqd * n_live, 0)
            adv = dataclasses.replace(adv, msgs=adv.msgs + extra)
            net = comm_lib.select_rows(act, net_adv, net)
        approx = torch.where(snap_mask, snap_payload, approx)
        comm_state = comm_lib.select_rows(act, adv, comm_state)
        if has_pull:
            # 7. a delivered token message overwrites its replica's pool
            # entry from the snapshot it carried: 1 if idle (jiq), the
            # headroom below x truncated to int32 (hsq).
            if static.comm == "jiq":
                fresh = (snap_payload == 0.0).to(_I32)
            else:
                fresh = torch.clamp_min(scn.x[:, None] - snap_payload, 0.0).to(_I32)
            tokens = torch.where(snap_mask, fresh, pull[0])
            pull = (tokens, pull[1])
            token_sum = token_sum + torch.where(act, tokens.sum(1, dtype=_I32), 0)
        if occ_trace is not None:
            occ_trace[:, t] = true_occ.to(_I32)

    if occ_trace is not None:
        # Frozen past every horizon: the final occupancy.
        occ_trace[:, t_end:] = (q_len + (rem > 0).sum(2, dtype=_I32))[:, None]
    carry = EngineCarry(
        q_len=q_len, q_head=q_head, q_work=q_work[:, :r_n].contiguous(),
        q_rid=q_rid[:, :r_n].contiguous(), rem=rem, arid=arid, approx=approx,
        comm=comm_state, rr_ptr=rr_ptr,
        comp_slot=metrics if stream else comp_slot[:, :n_cap].contiguous(),
        total_comp=total_comp, dropped=dropped, net=net, faulted=faulted,
        pull=(*pull, token_sum) if has_pull else None, suspect=suspect,
    )
    return carry, occ_trace


@dataclasses.dataclass
class ServeResult:
    """One serving run's outputs (host-side numpy; jct in rid order)."""

    jct: np.ndarray  # (completed,) completion times, rid (arrival) order
    jct_by_rid: np.ndarray  # (offered,) -1 where never completed
    completed: int
    offered: int
    messages: int
    dropped: int  # arrivals rejected on a full pending ring
    final_occupancy: np.ndarray  # (R,)
    mean_jct: float
    p99_jct: float
    msgs_per_completion: float
    net_drops: int = 0  # messages lost in flight (network="net")
    token_misses: int = 0  # pull routes that found an empty token pool
    token_sum: int = 0  # end-of-slot token-pool occupancy, summed over slots
    retrans: int = 0  # data retransmits (transport="ack")
    occupancy: Optional[np.ndarray] = None  # (T, R) when trace_occupancy

    @staticmethod
    def from_run(wl: ServeWorkload, comp_slot, msgs, total_comp, dropped,
                 final_occ, occ_trace=None, *, net_drops=0, token_misses=0,
                 token_sum=0, retrans=0) -> "ServeResult":
        comp_slot = np.asarray(comp_slot)[: wl.total].astype(np.int64)
        done = comp_slot >= 0
        jct_by_rid = np.where(done, comp_slot - wl.arrival_slot + 1, -1)
        jct = jct_by_rid[done]
        msgs = int(msgs)
        return ServeResult(
            jct=jct,
            jct_by_rid=jct_by_rid,
            completed=int(done.sum()),
            offered=wl.total,
            messages=msgs,
            dropped=int(dropped),
            final_occupancy=np.asarray(final_occ),
            mean_jct=float(jct.mean()) if jct.size else 0.0,
            p99_jct=float(np.percentile(jct, 99)) if jct.size else 0.0,
            msgs_per_completion=msgs / max(int(total_comp), 1),
            net_drops=int(net_drops),
            token_misses=int(token_misses),
            token_sum=int(token_sum),
            retrans=int(retrans),
            occupancy=None if occ_trace is None else np.asarray(occ_trace),
        )


def _round_up(n: int, mult: int) -> int:
    return ((max(n, 1) + mult - 1) // mult) * mult


def _pad_workload(wl: ServeWorkload, t_pad: int, a_pad: int, d: int = 0,
                  with_rid: bool = True):
    """Pad one workload to the ``(T, A)`` lane grid: ``(n_arr, work, tie_u,
    rid, sub_u)`` with lanes past a slot's arrival count zeroed.  ``d`` is
    the subset-uniform depth (``sqd`` under the "sqd" policy, else 0);
    ``with_rid=False`` (stream mode) leaves the rid lanes zero-width.
    The control-plane uniforms are padded by :func:`_pad_control`."""
    t = wl.n_arr.shape[0]
    n_arr = np.zeros(t_pad, np.int32)
    n_arr[:t] = wl.n_arr
    work = np.zeros((t_pad, a_pad), np.int32)
    tie_u = np.zeros((t_pad, a_pad), np.float32)
    rid = np.zeros((t_pad, a_pad if with_rid else 0), np.int32)
    sub_u = np.zeros((t_pad, a_pad, d), np.float32)
    if wl.total:
        lane = np.arange(a_pad, dtype=np.int64)[None, :]
        mask = lane < wl.n_arr[:, None]  # (t, a_pad) live lanes
        idx = np.minimum(wl.base[:, None] + lane, wl.total - 1)
        work[:t] = np.where(mask, wl.work[idx], 0)
        tie_u[:t] = np.where(mask, wl.tie_u[idx], 0.0)
        if with_rid:
            rid[:t] = np.where(mask, idx, 0)
        if d:
            sub_u[:t] = np.where(mask[..., None], wl.sub_u[idx, :d], 0.0)
    return n_arr, work, tie_u, rid, sub_u


def _control_streams(static: EngineStatic) -> tuple:
    """The ``ServeWorkload`` uniform streams the control plane's kinds read."""
    names = ()
    if static.network != "none":
        names += ("net_drop_u", "net_jit_u")
        if static.transport == "ack":
            names += ("ack_u",)
    if static.fault != "none":
        names += ("fault_u",)
    return names


def _pad_control(wl: ServeWorkload, name: str, t_pad: int) -> np.ndarray:
    """One control-plane stream of ``wl`` padded to ``t_pad`` slots."""
    arr = getattr(wl, name)
    if arr is None:
        raise ValueError(f"the workload has no {name} stream, which its cell's "
                         f"control plane reads")
    out = np.zeros((t_pad,) + arr.shape[1:], np.float32)
    out[: arr.shape[0]] = arr
    return out


def _core_args(wls: Sequence[ServeWorkload], cells: Sequence[ServeConfig],
               static: EngineStatic, n_cap: int, device) -> _CoreArgs:
    """The arguments of :func:`_serve_core` for one run per (workload,
    cell) pair: the padded lanes, the stacked scenario, ``static``,
    ``n_cap``, ``t_end``, the live lanes per slot and the control plane's
    uniforms."""
    d = static.sqd if static.policy == "sqd" else 0
    padded = [_pad_workload(w, static.slots, static.max_arrivals, d) for w in wls]
    # (T, D, ...) layout: each slot's lanes for every run are one
    # contiguous block, as the kernels take them.
    arrs = [
        torch.from_numpy(np.stack([p[i] for p in padded], axis=1)).to(device)
        for i in range(5)
    ]
    control = {
        name: torch.from_numpy(np.stack(
            [_pad_control(w, name, static.slots) for w in wls], axis=1)).to(device)
        for name in _control_streams(static)
    }
    scn = stack_scenarios([cell.scenario() for cell in cells])
    t_end = min(static.slots, max(int(scn.horizon.max()), 0))
    live_lanes = np.minimum(np.stack([p[0] for p in padded]).max(0), static.max_arrivals)
    return _CoreArgs(*arrs, scn.to(device), static, n_cap, t_end, live_lanes,
                     control or None)


def _run(wls: Sequence[ServeWorkload], cells: Sequence[ServeConfig],
         static: EngineStatic, n_cap: int, device) -> list[ServeResult]:
    """One run per (workload, cell) pair through :func:`_serve_core`."""
    out = _serve_core(*_core_args(wls, cells, static, n_cap, device))
    keys = ("comp_slot", "msgs", "total_comp", "dropped", "final_occ")
    counters = ("net_drops", "token_misses", "token_sum", "retrans")
    host = {k: out[k].cpu().numpy() for k in keys + counters + ("occupancy",)
            if out[k] is not None}
    return [
        ServeResult.from_run(
            wl, *(host[k][i] for k in keys),
            occ_trace=host["occupancy"][i] if "occupancy" in host else None,
            **{k: host[k][i] for k in counters},
        )
        for i, wl in enumerate(wls)
    ]


def serve_grid(
    seeds: Sequence[int],
    static: EngineStatic,
    cells: Sequence[ServeConfig],
    *,
    device: str | torch.device | None = None,
) -> list[list[ServeResult]]:
    """Run a whole serving grid as one batched run axis.

    Every cell replays the same seeds (the workload is keyed per (cell
    workload parameters, seed)); runs are flattened cell-major.
    ``static.slots`` is the padded loop length (>= every cell's ``slots``)
    and ``static.max_arrivals`` the lane width (0 = the batch maximum,
    rounded up to a multiple of 8).  Returns ``results[c][s]``, equal to
    :func:`serve_one` per cell and seed.  ``device=None`` means the CUDA
    card; pass ``device="cpu"`` for the plain PyTorch path.
    """
    dev = _resolve_device(device)
    flat_wls, flat_cells, static, n_cap = _grid_runs(seeds, static, cells)
    res = _run(flat_wls, flat_cells, static, n_cap, dev)
    s = len(seeds)
    return [res[c * s : (c + 1) * s] for c in range(len(cells))]


def _grid_runs(seeds: Sequence[int], static: EngineStatic,
               cells: Sequence[ServeConfig]) -> tuple:
    """The runs of a grid, cell-major: ``(workloads, cells, static with
    the lane width set, n_cap)``; checks every cell against ``static``."""
    _check_static(static)
    if static.stream:
        raise ValueError("EngineStatic.stream is the segment mode of serve_stream; "
                         "serve_grid runs the fixed horizon")
    cells = list(cells)
    seeds = [int(s) for s in seeds]
    for cell in cells:
        cs = cell.static_part()
        if (
            cs.replicas, cs.decode_slots, cs.queue_cap, cs.comm, cs.policy,
            cs.sqd, cs.use_rates, cs.route_backend, cs.deterministic_ties,
            cs.network, cs.transport, cs.fault,
        ) != (
            static.replicas, static.decode_slots, static.queue_cap,
            static.comm, static.policy, static.sqd, static.use_rates,
            static.route_backend, static.deterministic_ties, static.network,
            static.transport, static.fault,
        ):
            raise ValueError(
                f"cell static part {cs} does not match grid static {static}"
            )
        if cell.slots > static.slots:
            raise ValueError(
                f"cell slots {cell.slots} exceeds padded length {static.slots}"
            )
    flat_cells = [cell for cell in cells for _ in seeds]
    flat_wls = [workload_for(cell, s) for cell in cells for s in seeds]
    a_need = max(int(w.n_arr.max()) for w in flat_wls)
    a_pad = _round_up(a_need, 8)
    if static.max_arrivals:
        if static.max_arrivals < a_need:
            raise ValueError(
                f"static.max_arrivals={static.max_arrivals} below the "
                f"sampled batch maximum {a_need}"
            )
        a_pad = static.max_arrivals
    static = dataclasses.replace(static, max_arrivals=a_pad)
    n_cap = _round_up(max(w.total for w in flat_wls), 1024)
    return flat_wls, flat_cells, static, n_cap


def serve_one(
    seed: int,
    cell: ServeConfig,
    *,
    trace_occupancy: bool = False,
    workload=None,
    device: str | torch.device | None = None,
) -> ServeResult:
    """Run one serving cell (one seed) on its own.

    ``workload`` overrides the cached sampler stream; any object with the
    fields of :class:`ServeWorkload` (such as the reference's) is copied
    in by :meth:`ServeWorkload.from_arrays`.  It must cover at most
    ``cell.slots`` slots.  ``device=None`` means the CUDA card.
    """
    dev = _resolve_device(device)
    if workload is None:
        wl = workload_for(cell, seed)
    else:
        wl = ServeWorkload.from_arrays(workload)
    if wl.n_arr.shape[0] > cell.slots:
        raise ValueError(
            f"workload covers {wl.n_arr.shape[0]} slots, cell.slots is {cell.slots}"
        )
    a_need = max(int(wl.n_arr.max()), 1)
    if cell.max_arrivals:
        if cell.max_arrivals < a_need:
            raise ValueError(
                f"max_arrivals={cell.max_arrivals} below the sampled "
                f"per-slot maximum {a_need}"
            )
        a_pad = cell.max_arrivals
    else:
        a_pad = _round_up(a_need, 8)
    static = dataclasses.replace(
        cell.static_part(), max_arrivals=a_pad, trace_occupancy=trace_occupancy
    )
    return _run([wl], [cell], static, _round_up(wl.total, 1024), dev)[0]


# ---------------------------------------------------------------------------
# The streaming (segment) engine: chunks of slots in O(chunk) memory.
# ---------------------------------------------------------------------------

# Granularity of the prefix-stable stream sampler: every quantity of block
# j (slots [j*B, (j+1)*B)) is drawn from its own SeedSequence child keyed
# (stream, j), so block j's bytes never depend on how, or whether, other
# blocks were sampled.  Chunk boundaries need not align with blocks.
STREAM_BLOCK = 1024


@dataclasses.dataclass(frozen=True)
class StreamParams:
    """Workload parameters of one request stream (hashable): what the
    sampler needs and nothing the router reads.  ``diurnal_amp`` /
    ``diurnal_period`` modulate the arrival rate as ``rate * (1 + amp *
    sin(2 pi t / period))``; 0 / 0 keeps it flat."""

    replicas: int
    decode_slots: int
    load: float
    mean_prefill: float = 4.0
    mean_decode: float = 64.0
    rate_scale: float = 1.0
    with_net: bool = False
    with_fault: bool = False
    with_ack: bool = False
    diurnal_amp: float = 0.0
    diurnal_period: int = 0

    @staticmethod
    def for_cell(cell: ServeConfig, *, diurnal_amp: float = 0.0,
                 diurnal_period: int = 0) -> "StreamParams":
        return StreamParams(
            replicas=cell.replicas,
            decode_slots=cell.decode_slots,
            load=cell.load,
            mean_prefill=float(cell.mean_prefill),
            mean_decode=float(cell.mean_decode),
            rate_scale=cell.rate_scale(),
            with_net=cell.network != "none",
            with_fault=cell.fault != "none",
            with_ack=cell.network != "none" and cell.transport == "ack",
            diurnal_amp=diurnal_amp,
            diurnal_period=diurnal_period,
        )


@dataclasses.dataclass
class _StreamBlock:
    """One sampled block: per-slot arrivals plus per-arrival draws."""

    n_arr: np.ndarray  # (B,) int64
    cum: np.ndarray  # (B + 1,) int64 arrivals before each in-block slot
    prefill: np.ndarray  # (total,) int64
    decode: np.ndarray  # (total,) int64
    work: np.ndarray  # (total,) int64
    tie_u: np.ndarray  # (total,) float32
    sub_u: np.ndarray  # (total, SQD_MAX) float32
    net_drop_u: Optional[np.ndarray]  # (B, R) float32
    net_jit_u: Optional[np.ndarray]  # (B, R) float32
    fault_u: Optional[np.ndarray]  # (B, R) float32
    ack_u: Optional[np.ndarray]  # (B, 4, R) float32


class StreamSampler:
    """Prefix-stable chunked workload sampling (the host side of the stream).

    The reference's sampler, line for line: six root ``SeedSequence``
    children split the streams as :func:`sample_workload` does, and block
    ``j`` of each stream draws from the j-th child of that child, built
    statelessly as ``SeedSequence(entropy, spawn_key + (j,))``.  Block j's
    bytes are a function of (seed, params, j) alone, so slabs of any size
    in any order assemble into one trace.  A small LRU of blocks keeps
    sequential slabs O(chunk) in time and memory.
    """

    _CACHE_BLOCKS = 8

    def __init__(self, seed: int, params: StreamParams):
        self.seed = int(seed)
        self.params = params
        # workload, tie, subset, net, fault, ack
        self._roots = np.random.SeedSequence(self.seed).spawn(6)
        self._cache: dict[int, _StreamBlock] = {}

    def _rng(self, stream: int, j: int) -> np.random.Generator:
        child = self._roots[stream]
        ss = np.random.SeedSequence(
            entropy=child.entropy, spawn_key=child.spawn_key + (j,)
        )
        return np.random.default_rng(ss)

    def rate_at(self, t: np.ndarray) -> np.ndarray:
        """Offered per-slot arrival rate at absolute slots ``t``."""
        p = self.params
        mean_work = p.mean_prefill + p.mean_decode
        base = p.load * p.replicas * p.decode_slots * p.rate_scale / mean_work
        if not p.diurnal_period:
            return np.full(np.shape(t), base)
        phase = 2.0 * np.pi * np.asarray(t, np.float64) / p.diurnal_period
        return base * (1.0 + p.diurnal_amp * np.sin(phase))

    def _block(self, j: int) -> _StreamBlock:
        blk = self._cache.get(j)
        if blk is not None:
            return blk
        p, b = self.params, STREAM_BLOCK
        t = j * b + np.arange(b, dtype=np.int64)
        wrng = self._rng(0, j)
        n_arr = wrng.poisson(self.rate_at(t)).astype(np.int64)
        total = int(n_arr.sum())
        prefill = 1 + wrng.poisson(p.mean_prefill, size=total).astype(np.int64)
        decode = 1 + wrng.poisson(p.mean_decode, size=total).astype(np.int64)
        work = np.maximum(prefill + decode, 1)
        tie_u = self._rng(1, j).random(size=total, dtype=np.float32)
        sub_u = self._rng(2, j).random(size=(total, SQD_MAX), dtype=np.float32)
        net_drop_u = net_jit_u = fault_u = ack_u = None
        if p.with_net:
            nrng = self._rng(3, j)
            net_drop_u = nrng.random(size=(b, p.replicas), dtype=np.float32)
            net_jit_u = nrng.random(size=(b, p.replicas), dtype=np.float32)
        if p.with_fault:
            fault_u = self._rng(4, j).random(size=(b, p.replicas), dtype=np.float32)
        if p.with_ack:
            ack_u = self._rng(5, j).random(size=(b, 4, p.replicas), dtype=np.float32)
        blk = _StreamBlock(
            n_arr=n_arr,
            cum=np.concatenate([[0], np.cumsum(n_arr)]).astype(np.int64),
            prefill=prefill, decode=decode, work=work, tie_u=tie_u, sub_u=sub_u,
            net_drop_u=net_drop_u, net_jit_u=net_jit_u, fault_u=fault_u,
            ack_u=ack_u,
        )
        if len(self._cache) >= self._CACHE_BLOCKS:
            self._cache.pop(next(iter(self._cache)))
        self._cache[j] = blk
        return blk

    def slab(self, t0: int, t1: int) -> ServeWorkload:
        """The trace of slots ``[t0, t1)`` as a :class:`ServeWorkload`:
        ``base`` slab-local, ``arrival_slot`` absolute; byte-identical to the
        same span of any other slabbing."""
        if not 0 <= t0 < t1:
            raise ValueError(f"bad slab bounds [{t0}, {t1})")
        b = STREAM_BLOCK
        parts = []
        for j in range(t0 // b, (t1 - 1) // b + 1):
            blk = self._block(j)
            lo = max(t0 - j * b, 0)
            hi = min(t1 - j * b, b)
            parts.append((blk, lo, hi, int(blk.cum[lo]), int(blk.cum[hi])))
        n_arr = np.concatenate([blk.n_arr[lo:hi] for blk, lo, hi, _, _ in parts])

        def cat(name):  # per-arrival draws
            return np.concatenate([getattr(blk, name)[a0:a1]
                                   for blk, _, _, a0, a1 in parts])

        def cat_slots(name):  # per-slot control-plane rows, None when off
            if getattr(parts[0][0], name) is None:
                return None
            return np.concatenate([getattr(blk, name)[lo:hi]
                                   for blk, lo, hi, _, _ in parts])

        return ServeWorkload(
            n_arr=n_arr,
            base=np.concatenate([[0], np.cumsum(n_arr)[:-1]]).astype(np.int64),
            prefill=cat("prefill"), decode=cat("decode"), work=cat("work"),
            tie_u=cat("tie_u"), sub_u=cat("sub_u"),
            arrival_slot=np.repeat(np.arange(t0, t1, dtype=np.int64), n_arr),
            net_drop_u=cat_slots("net_drop_u"), net_jit_u=cat_slots("net_jit_u"),
            fault_u=cat_slots("fault_u"), ack_u=cat_slots("ack_u"),
        )

    def full(self, slots: int) -> ServeWorkload:
        """The whole trace of the first ``slots`` slots (O(slots) memory),
        for ``serve_one(workload=...)``."""
        return self.slab(0, slots)


@dataclasses.dataclass
class StreamState:
    """Where a :func:`serve_stream` segment ended, to resume from.

    ``carry`` is the :class:`EngineCarry` on the device the next chunk
    reads; on the card the fused backend advances it in place, so a state
    resumes once (copy it with :func:`repro_torch.core.care.comm.snapshot_state`
    first to keep it).
    """

    carry: EngineCarry
    t_next: int
    offered: int
    a_pad: int
    sampler: StreamSampler


@dataclasses.dataclass
class StreamResult:
    """One stream segment's outputs (host-side numbers and histogram)."""

    slots: int  # slots run, cumulative over resumed segments
    offered: int
    completed: int  # all completions, warmup included
    dropped: int
    messages: int
    net_drops: int
    count: int  # post-warmup completions in the accumulators
    mean_jct: float
    std_jct: float
    max_jct: int
    hist: np.ndarray  # (HIST_BUCKETS,) int64
    final_occupancy: np.ndarray  # (R,)
    state: StreamState
    token_misses: int = 0  # pull routes that found an empty token pool
    token_sum: int = 0  # end-of-slot token-pool occupancy over slots
    retrans: int = 0  # data retransmits (transport="ack")

    @property
    def msgs_per_slot(self) -> float:
        return self.messages / max(self.slots, 1)

    @property
    def msgs_per_completion(self) -> float:
        return self.messages / max(self.completed, 1)

    def jct_summary(self) -> dict:
        """Count, mean, std, max and the histogram's tail quantiles; all 0
        when nothing was measured."""
        return metrics_lib.stream_summary(
            self.count, self.mean_jct,
            self.std_jct * self.std_jct * max(self.count, 1),
            self.max_jct, self.hist,
        )


def _to_device(arr: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array on ``dev``; to the card through pinned memory without
    waiting, so that sampling the next chunk overlaps the running one."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


def serve_stream(
    seed: int,
    cell: ServeConfig,
    *,
    chunk: int = 4096,
    warmup: int = 0,
    slots: Optional[int] = None,
    sampler: Optional[StreamSampler] = None,
    state: Optional[StreamState] = None,
    prefetch: bool = True,
    diurnal_amp: float = 0.0,
    diurnal_period: int = 0,
    device: str | torch.device | None = None,
) -> StreamResult:
    """Run one serving cell as a chunked stream in bounded memory.

    ``slots`` (default ``cell.slots``) run as ``ceil(slots / chunk)`` chunk
    steps that thread one :class:`EngineCarry`; on the card the fused
    backend is one ``serve_slots`` launch a chunk.  With ``prefetch=True``
    the host samples chunk k+1's slab after chunk k is launched and before
    anything waits for the card; ``prefetch=False`` waits for each chunk
    first (the same results).

    Any chunking, and the fixed-horizon engine fed
    ``StreamSampler.full(slots)``, give the same counters and carried
    state bit for bit.  ``warmup`` keeps completions before that absolute
    slot out of the JCT accumulators (the counters are never gated).
    ``state`` resumes a previous segment (once); totals are cumulative.
    The stream's end must stay below 2^31 (the int32 slot clock).
    ``device=None`` means the CUDA card; pass ``device="cpu"`` for the
    plain PyTorch path.
    """
    if cell.route_backend == "fused" and cell.policy != "jsaq":
        raise ValueError("stream mode inherits the fused jsaq-only limits")
    slots = cell.slots if slots is None else int(slots)
    if slots <= 0:
        raise ValueError(f"slots must be positive, got {slots}")
    if chunk <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")
    base_static = dataclasses.replace(cell.static_part(), stream=True)  # validates the cell
    dev = _resolve_device(device)
    d = base_static.sqd if base_static.policy == "sqd" else 0

    if state is not None:
        where = state.carry.q_len.device
        if where.type != dev.type or dev.index not in (None, where.index):
            raise ValueError(f"the state lies on {where}, not {dev}")
        dev = where
        sampler = state.sampler
        t_start, offered = state.t_next, state.offered
        carry, a_pad = state.carry, state.a_pad
    else:
        if sampler is None:
            sampler = StreamSampler(seed, StreamParams.for_cell(
                cell, diurnal_amp=diurnal_amp, diurnal_period=diurnal_period))
        t_start, offered = 0, 0
        carry, a_pad = _engine_init(base_static, 0, 1, dev), 8
    t_end = t_start + slots
    if t_end >= np.iinfo(np.int32).max:
        raise ValueError(f"stream end {t_end} overflows the int32 slot clock")
    scn = stack_scenarios([dataclasses.replace(
        cell.scenario(), horizon=torch.tensor(t_end, dtype=_I32),
        warmup=torch.tensor(int(warmup), dtype=_I32),
    )]).to(dev)
    controls = _control_streams(base_static)
    n_chunks = -(-slots // chunk)

    def prep(k: int) -> _CoreArgs:
        """Sample, pad and stage chunk k's slab (the host half of overlap)."""
        nonlocal a_pad, offered
        c0 = t_start + k * chunk
        c1 = min(c0 + chunk, t_end)
        wl = sampler.slab(c0, c1)
        offered += wl.total
        need = int(wl.n_arr.max()) if wl.n_arr.size else 0
        if need > a_pad:
            a_pad = _round_up(need, 8)
        static_k = dataclasses.replace(base_static, slots=chunk, max_arrivals=a_pad)
        padded = _pad_workload(wl, chunk, a_pad, d, with_rid=False)
        arrs = [_to_device(p[:, None], dev) for p in padded]
        control = {name: _to_device(_pad_control(wl, name, chunk)[:, None], dev)
                   for name in controls}
        live = np.minimum(padded[0], a_pad)
        return _CoreArgs(*arrs, scn, static_k, 0, c1 - c0, live, control or None,
                         None, c0)

    cur = prep(0)
    for k in range(n_chunks):
        carry = _serve_core(*cur._replace(carry=carry))
        if not prefetch and dev.type == "cuda":
            torch.cuda.synchronize(dev)
        if k + 1 < n_chunks:
            cur = prep(k + 1)

    q_len = carry.q_len[0].cpu().numpy()
    final_occ = q_len + (carry.rem[0] > 0).sum(1, dtype=_I32).cpu().numpy()
    sm = carry.comp_slot
    count = int(sm.count[0])
    net, pull = carry.net, carry.pull
    return StreamResult(
        slots=t_end,
        offered=offered,
        completed=int(carry.total_comp[0]),
        dropped=int(carry.dropped[0]),
        messages=int(carry.comm.msgs[0]),
        net_drops=int(net.drops[0]) if net is not None else 0,
        count=count,
        mean_jct=float(sm.mean[0]),
        std_jct=float(np.sqrt(max(float(sm.m2[0]), 0.0) / max(count, 1))),
        max_jct=int(sm.max_jct[0]),
        hist=sm.hist[0].cpu().numpy().astype(np.int64),
        final_occupancy=final_occ,
        state=StreamState(carry=carry, t_next=t_end, offered=offered, a_pad=a_pad,
                          sampler=sampler),
        token_misses=int(pull[1][0]) if pull is not None else 0,
        token_sum=int(pull[2][0]) if pull is not None else 0,
        retrans=int(net.retrans[0]) if isinstance(net, comm_lib.AckNetState) else 0,
    )
