"""Discrete-time slotted simulator for the CARE model (paper Section 9).

Port of ``repro/core/care/slotted_sim.py``.  K parallel FIFO servers and one
load balancer; in every slot, in this order:

  1. an arrival (Bernoulli(``load``), or Markov-modulated with
     ``arrival="mmpp"``, either one optionally under a diurnal curve) is
     routed on the *pre-slot* state (a full FIFO, ``q >= buffer_cap``,
     drops it and counts the drop);
  2. every busy server works one unit, or its rate's credit under
     heterogeneous ``service_rates``; the head job departs when its
     remaining requirement reaches zero;
  3. the balancer's emulation advances one slot (:mod:`.approx`);
  4. the communication pattern (:mod:`.comm`) fires, and every triggered
     server's exact queue length snaps the approximation to the truth.

So the end-of-slot error obeys ``AQ <= x - 1`` for DT-x and ET-x with the
matching emulation (Theorem 2.3).

Configuration is split as in the reference: :class:`StaticConfig` holds
shapes and kinds (Python-level dispatch), :class:`Scenario` the numeric
operands of one cell, which become one row of per-run tensors.  A run is
one (cell, seed) pair and the run axis is flattened cell-major,
``run = cell * S + seed``.  Slots at ``t >= horizon`` are frozen no-ops.

Randomness is an input.  :func:`draw_workload` draws arrivals, job sizes
and the policies' per-slot draws (tie-break Gumbels, SQ(d) subsets, random
picks, arrival classes) from one ``torch.Generator`` per seed, and every
cell replays the same uniforms for the same seed.  :func:`run_draws` takes
those draws as tensors, so a caller (the tests) can feed it the
reference's own draws.

Two backends select the engine that runs the slot loop:

* ``"dense"`` -- the port of ``_sim_core``: a Python loop over slots of
  batched ``(N, K)`` tensor operations, with the per-job FIFO ring, the
  overflow drop and job completion times (JCT).
* ``"fused"`` -- the counterpart of the reference's ``"pallas"`` backend:
  one call of :func:`repro_torch.kernels.ops.care_route` for the whole run
  axis (the CUDA kernel on the card, its plain version on the CPU).  It
  carries no FIFO ring, so it reports no JCT, and it accepts exactly the
  configurations the reference's pallas backend accepts.

Policies: jsq, jsaq, sq2 / sqd, rr, random, and the pull policies jiq /
hsq with their balancer-side token pool.  Multi-class arrivals route
within their class's server affinity.

The degraded control plane runs on the dense backend (the fused one
refuses it, as the reference's pallas backend does):

* ``fault="crash"`` / ``"slow"``: a crash <-> healthy chain a server,
  advanced first in each slot (frozen past the horizon); a crashed server
  works nothing and cannot send (a recovery forces a resync), a slowed one
  works at ``slow_factor`` of its rate;
* ``network="net"``: every message goes through ``comm.net_step`` (delay,
  jitter, drop, piggyback) or, with ``transport="ack"``,
  ``comm.net_step_ack``; the balancer's emulation and token pool take the
  *delivered* payload.  jsq and SQ(d) route on a ring of end-of-slot
  queues ``net_delay`` slots old, and SQ(d)'s ``2 d`` queries an arrival
  are billed as messages;
* ``suspect_age > 0``: servers not heard from for longer are excluded from
  routing (keepalive-driven under ``"ack"``), composed with the class
  affinity (the affinity wins an empty intersection).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.care import approx as approx_lib
from repro_torch.core.care import comm as comm_lib
from repro_torch.core.care import routing as routing_lib
from repro_torch.core.care import workload as workload_lib
from repro_torch.kernels import ops as kernel_ops

_I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class StaticConfig:
    """Shapes and kinds of a simulator run (hashable).

    ``slots`` is the padded loop length; each cell's effective length is
    its ``Scenario.horizon``.  ``route_backend`` is ``"dense"`` or
    ``"fused"``; ``deterministic_ties`` breaks shortest-queue ties to the
    lowest index instead of uniformly at random (the fused kernel's rule).
    ``sqd`` is SQ(d)'s d; ``use_rates`` puts heterogeneous service rates in
    play and ``rate_aware`` makes the queue-reading policies route on the
    expected drain time ``q_i * E[S] / r_i``.  ``network`` / ``transport``
    / ``fault`` are the control plane's kinds and ``net_delay_cap`` the
    capacity of the stale-queue ring (above every cell's ``net_delay``).
    ``classes`` is the number of arrival classes; ``constrained`` applies
    the affinity mask also to a single class.
    """

    servers: int = 30
    slots: int = 100_000
    policy: str = "jsaq"
    comm: str = "et"
    approx: str = "msr"
    buffer_cap: int = 2048
    sqd: int = 2
    arrival: str = "bernoulli"
    service: str = "geometric"
    use_rates: bool = False
    rate_aware: bool = True
    route_backend: str = "dense"
    deterministic_ties: bool = False
    network: str = "none"
    transport: str = "fire_forget"
    fault: str = "none"
    net_delay_cap: int = 32
    classes: int = 1
    constrained: bool = False


@dataclasses.dataclass(frozen=True, eq=False)
class Scenario:
    """Numeric operands of one grid cell, float32 / int32 as the reference
    carries them.  ``rt_period`` (from ``rt_rate``) and the MMPP state
    rates ``lam_hi`` / ``lam_lo`` (from ``load`` and ``burst_intensity``)
    are derived host-side in float64 and cast once.  ``service_rates``
    ``(K,)`` is ``None`` for unit rates and ``class_affinity`` ``(C, K)``
    ``None`` for every server eligible to every class.  The control-plane
    operands are neutral when their kinds are off."""

    load: np.float32
    x: np.int32
    rt_rate: np.float32
    rt_period: np.int32
    service: workload_lib.ServiceProcess
    horizon: np.int32
    burst_intensity: np.float32
    burst_stay: np.float32
    lam_hi: np.float32
    lam_lo: np.float32
    service_rates: Optional[np.ndarray]
    diurnal_amp: np.float32
    diurnal_period: np.float32
    class_mix: np.ndarray
    class_affinity: Optional[np.ndarray]
    net_delay: np.int32 = np.int32(0)
    net_jitter: np.int32 = np.int32(0)
    net_drop: np.float32 = np.float32(0.0)
    suspect_age: np.int32 = np.int32(0)
    ack_timeout: np.int32 = np.int32(0)
    backoff_base: np.float32 = np.float32(1.0)
    max_retries: np.int32 = np.int32(0)
    ka_period: np.int32 = np.int32(0)
    crash_rate: np.float32 = np.float32(0.0)
    recover_rate: np.float32 = np.float32(0.0)
    slow_factor: np.float32 = np.float32(1.0)

    @staticmethod
    def create(
        load: float,
        x: int = 3,
        rt_rate: float = 0.01,
        mean_service: float = 30,
        service: str = "geometric",
        horizon: Optional[int] = None,
        *,
        servers: Optional[int] = None,
        burst_intensity: float = 1.6,
        burst_stay: float = 0.98,
        service_rates: Optional[Sequence[float]] = None,
        service_tail: float = 2.0,
        diurnal_amp: float = 0.0,
        diurnal_period: float = 1.0,
        arrival: str = "bernoulli",  # diurnal peak-rate validation only
        network: str = "none",  # control-plane validation only
        net_delay: int = 0,
        net_jitter: int = 0,
        net_drop: float = 0.0,
        suspect_age: int = 0,
        transport: str = "fire_forget",  # control-plane validation only
        ack_timeout: int = 0,
        backoff_base: float = 1.0,
        max_retries: int = 0,
        ka_period: int = 0,
        fault: str = "none",  # control-plane validation only
        crash_rate: float = 0.0,
        recover_rate: float = 0.0,
        slow_factor: float = 1.0,
        class_mix: Optional[Sequence[float]] = None,
        class_affinity: Optional[Sequence[Sequence[bool]]] = None,
        policy: Optional[str] = None,  # pull-pairing validation only
        comm: Optional[str] = None,  # pull-pairing validation only
    ) -> "Scenario":
        """Build one cell with the reference's validations.

        ``servers`` checks the width of ``class_affinity`` (the simulator
        checks it again against ``StaticConfig.servers``).
        """
        comm_lib.validate_control_plane(
            network=network, net_delay=net_delay, net_jitter=net_jitter,
            net_drop=net_drop, suspect_age=suspect_age, transport=transport,
            ack_timeout=ack_timeout, backoff_base=backoff_base,
            max_retries=max_retries, ka_period=ka_period, fault=fault,
            crash_rate=crash_rate, recover_rate=recover_rate,
            slow_factor=slow_factor, policy=policy, comm=comm,
            token_refresh=rt_rate if policy == "hsq" else None,
        )
        if class_affinity is not None and class_mix is None:
            raise ValueError(
                "class_affinity requires class_mix (one weight per class)"
            )
        if class_mix is None:
            mix, aff = np.ones((1,), np.float32), None
        else:
            mix64 = np.asarray(class_mix, np.float64)
            if mix64.ndim != 1 or mix64.size < 1:
                raise ValueError(
                    f"class_mix must be a 1-D weight vector, got shape {mix64.shape}"
                )
            if np.any(mix64 < 0) or mix64.sum() <= 0:
                raise ValueError(
                    "class_mix weights must be >= 0 with a positive sum, "
                    f"got {class_mix}"
                )
            mix, aff = mix64.astype(np.float32), None
            if class_affinity is not None:
                aff = np.asarray(class_affinity, bool)
                width = servers if servers is not None else aff.shape[-1]
                if aff.shape != (mix.size, width):
                    raise ValueError(
                        f"class_affinity must have shape (classes, servers) = "
                        f"({mix.size}, {width}), got {aff.shape}"
                    )
                if not aff.any(axis=1).all():
                    empty = int(np.argmin(aff.any(axis=1)))
                    raise ValueError(
                        f"class_affinity row {empty} has no eligible server; "
                        "every class needs at least one"
                    )
        lam_hi = min(burst_intensity * load, 1.0)
        lam_lo = max(2.0 * load - lam_hi, 0.0)
        period = max(int(round(1.0 / max(rt_rate, 1e-9))), 1)
        diurnal_amp = float(diurnal_amp)
        if not 0.0 <= diurnal_amp <= 1.0:
            raise ValueError(
                f"diurnal_amp must be in [0, 1] (rate stays non-negative), "
                f"got {diurnal_amp}"
            )
        # The highest modulated rate must stay a probability, or u < rate
        # clips the sine's peaks and the long-run rate drops below load.
        # For mmpp that peak is the burst state's rate.
        base_peak = lam_hi if arrival == "mmpp" else load
        if diurnal_amp and base_peak * (1.0 + diurnal_amp) > 1.0 + 1e-9:
            raise ValueError(
                f"diurnal peak rate {base_peak:.4f}*(1+amp) = "
                f"{base_peak * (1.0 + diurnal_amp):.4f} exceeds 1 "
                f"(arrival={arrival!r}); lower amp to at most "
                f"{1.0 / base_peak - 1.0:.4f}"
            )
        if horizon is None:
            horizon = np.iinfo(np.int32).max  # unbounded: never mask
        return Scenario(
            load=np.float32(load),
            x=np.int32(x),
            rt_rate=np.float32(rt_rate),
            rt_period=np.int32(period),
            service=workload_lib.ServiceProcess.create(
                kind=service, mean=mean_service, tail=service_tail
            ),
            horizon=np.int32(horizon),
            burst_intensity=np.float32(burst_intensity),
            burst_stay=np.float32(burst_stay),
            lam_hi=np.float32(lam_hi),
            lam_lo=np.float32(lam_lo),
            service_rates=(
                None if service_rates is None
                else np.asarray(service_rates, np.float32)
            ),
            diurnal_amp=np.float32(diurnal_amp),
            diurnal_period=np.float32(max(float(diurnal_period), 1e-6)),
            class_mix=mix,
            class_affinity=aff,
            net_delay=np.int32(net_delay),
            net_jitter=np.int32(net_jitter),
            net_drop=np.float32(net_drop),
            suspect_age=np.int32(suspect_age),
            ack_timeout=np.int32(ack_timeout),
            backoff_base=np.float32(backoff_base),
            max_retries=np.int32(max_retries),
            ka_period=np.int32(ka_period),
            crash_rate=np.float32(crash_rate),
            recover_rate=np.float32(recover_rate),
            slow_factor=np.float32(slow_factor),
        )


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """One grid cell as the user sees it: :meth:`static_part` + :meth:`scenario`.

    Beyond the paper's Section 9.1 setting: ``arrival="mmpp"`` with
    ``burst_intensity`` / ``burst_stay`` for bursty arrivals (long-run rate
    ``load``); ``service`` in geometric / deterministic / pareto / weibull
    with ``service_tail`` the Pareto alpha or Weibull shape;
    ``diurnal_amp`` / ``diurnal_period`` for a sinusoidal load curve;
    ``service_rates`` (one speed a server) with ``rate_aware`` drain-time
    routing; ``class_mix`` / ``class_affinity`` for constrained routing.
    The degraded control plane: ``network="net"`` with ``net_delay``,
    ``net_jitter``, ``net_drop``; ``transport="ack"`` with ``ack_timeout``,
    ``backoff_base``, ``max_retries``, ``ka_period``; ``fault`` in crash /
    slow with ``crash_rate``, ``recover_rate``, ``slow_factor``;
    ``suspect_age`` (0 = no suspect masking) and ``net_delay_cap``.
    """

    servers: int = 30
    slots: int = 100_000
    load: float = 0.95
    mean_service: int = 30
    policy: str = "jsaq"
    comm: str = "et"
    x: int = 3
    rt_rate: float = 0.01
    approx: str = "msr"
    buffer_cap: int = 2048
    sqd: int = 2
    arrival: str = "bernoulli"
    burst_intensity: float = 1.6
    burst_stay: float = 0.98
    service_rates: Optional[tuple] = None
    rate_aware: bool = True
    service: str = "geometric"
    service_tail: float = 2.0
    diurnal_amp: float = 0.0
    diurnal_period: float = 1.0
    max_slots: Optional[int] = None
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
    net_delay_cap: int = 32
    class_mix: Optional[tuple] = None
    class_affinity: Optional[tuple] = None

    def static_part(self) -> StaticConfig:
        if self.max_slots is not None and self.max_slots < self.slots:
            raise ValueError(
                f"max_slots ({self.max_slots}) must be >= slots ({self.slots})"
            )
        if self.comm == "exact" and self.network != "none":
            raise ValueError(_EXACT_OVER_NET)
        return StaticConfig(
            servers=self.servers,
            slots=self.max_slots if self.max_slots is not None else self.slots,
            policy=self.policy,
            comm=self.comm,
            approx=self.approx,
            buffer_cap=self.buffer_cap,
            sqd=self.sqd,
            arrival=self.arrival,
            service=self.service,
            use_rates=self.service_rates is not None,
            rate_aware=self.rate_aware,
            route_backend=self.route_backend,
            deterministic_ties=self.deterministic_ties,
            network=self.network,
            transport=self.transport,
            fault=self.fault,
            net_delay_cap=self.net_delay_cap,
            classes=len(self.class_mix) if self.class_mix is not None else 1,
            constrained=self.class_affinity is not None,
        )

    def scenario(self) -> Scenario:
        return Scenario.create(
            load=self.load,
            x=self.x,
            rt_rate=self.rt_rate,
            mean_service=self.mean_service,
            service=self.service,
            horizon=self.slots,
            servers=self.servers,
            burst_intensity=self.burst_intensity,
            burst_stay=self.burst_stay,
            service_rates=self.service_rates,
            service_tail=self.service_tail,
            diurnal_amp=self.diurnal_amp,
            diurnal_period=self.diurnal_period,
            arrival=self.arrival,
            network=self.network,
            net_delay=self.net_delay,
            net_jitter=self.net_jitter,
            net_drop=self.net_drop,
            suspect_age=self.suspect_age,
            transport=self.transport,
            ack_timeout=self.ack_timeout,
            backoff_base=self.backoff_base,
            max_retries=self.max_retries,
            ka_period=self.ka_period,
            fault=self.fault,
            crash_rate=self.crash_rate,
            recover_rate=self.recover_rate,
            slow_factor=self.slow_factor,
            class_mix=self.class_mix,
            class_affinity=self.class_affinity,
            policy=self.policy,
            comm=self.comm,
        )


@dataclasses.dataclass
class SimResult:
    """Simulation outputs of one run (host-side numpy)."""

    jct: np.ndarray  # (num_jobs,) job completion times in slots (>= 1)
    arrivals: int  # admitted arrivals (offered minus dropped)
    departures: int
    messages: int
    max_aq: int  # sup_t AQ(t) observed at slot ends
    max_queue: int
    overflow: bool  # any arrival dropped on a full FIFO
    per_server_arrivals: np.ndarray  # (K,)
    final_q: np.ndarray  # (K,)
    msgs_per_departure: float = 0.0  # the exact-state baseline is 1
    queue_gap_sup: int = 0  # sup_t max_ij |Q_i - Q_j|
    dropped: int = 0  # arrivals rejected because the FIFO was full
    net_drops: int = 0  # messages lost in flight (network="net")
    retrans: int = 0  # data retransmits (transport="ack")
    # Pull-policy counters (jiq / hsq; zero otherwise).
    token_misses: int = 0  # arrivals routed with an empty token pool
    token_sum: int = 0  # sum over active slots of the end-of-slot pool


def _check_fused_static(static: StaticConfig) -> None:
    """Refuse what the fused kernel does not model, exactly as the
    reference's ``_check_pallas_static`` refuses it: shortest-queue routing
    with lowest-index ties, MSR emulation, deterministic jobs at unit
    rates, no control-plane model and no routing constraints.  (Arrivals
    are an input of the kernel, so MMPP and diurnal arrivals run on it.)"""
    if static.policy not in ("jsq", "jsaq"):
        raise ValueError(
            f"route_backend='fused' supports policies 'jsq'/'jsaq', got "
            f"{static.policy!r}"
        )
    if static.approx != "msr":
        raise ValueError(
            f"route_backend='fused' requires approx='msr', got {static.approx!r}"
        )
    if static.service != "deterministic":
        raise ValueError(
            f"route_backend='fused' requires service='deterministic' (per-job "
            f"sizes live in a FIFO ring the kernel does not carry), got "
            f"{static.service!r}"
        )
    if static.use_rates:
        raise ValueError(
            "route_backend='fused' requires homogeneous unit service rates"
        )
    if not static.deterministic_ties:
        raise ValueError(
            "route_backend='fused' requires deterministic_ties=True (the "
            "kernel breaks ties to the lowest index)"
        )
    if static.network != "none" or static.fault != "none":
        raise NotImplementedError(
            f"route_backend='fused' does not implement the fault-injection "
            f"control plane (network={static.network!r}, "
            f"fault={static.fault!r}): care_route carries no in-flight "
            f"message buffer or fault state -- use route_backend='dense'"
        )
    if static.classes > 1 or static.constrained:
        raise NotImplementedError(
            f"route_backend='fused' does not implement constrained routing "
            f"(classes={static.classes}, constrained={static.constrained}): "
            f"the kernel carries no per-class affinity masks -- use "
            f"route_backend='dense'"
        )


_EXACT_OVER_NET = (
    "comm='exact' cannot run through the network model: its per-departure "
    "message accounting (Prop 6.1) assumes instant delivery -- use "
    "comm='dt' with x=1 for a near-exact pattern under network='net'"
)


def _check_static(static: StaticConfig) -> None:
    """Refuse unknown kinds and what the chosen backend does not model."""
    if static.route_backend not in ("dense", "fused"):
        raise ValueError(
            f"route_backend must be 'dense' or 'fused', got {static.route_backend!r}"
        )
    if static.route_backend == "fused":
        _check_fused_static(static)
    for name, value, allowed in (
        ("network kind", static.network, ("none", "net")),
        ("transport kind", static.transport, ("fire_forget", "ack")),
        ("fault kind", static.fault, ("none", "crash", "slow")),
        ("policy", static.policy, routing_lib.POLICIES),
        ("comm", static.comm, comm_lib.PUSH_KINDS + comm_lib.PULL_KINDS),
        ("approx", static.approx, ("basic", "msr", "msr_x")),
        ("arrival", static.arrival, ("bernoulli", "mmpp")),
        ("service", static.service, workload_lib.SERVICE_KINDS),
    ):
        if value not in allowed:
            raise ValueError(f"unknown {name}: {value!r}")
    pull = static.policy in routing_lib.PULL_POLICIES
    if pull and static.comm != static.policy:
        raise ValueError(
            f"policy={static.policy!r} requires comm={static.policy!r} "
            f"(its token channel), got comm={static.comm!r}"
        )
    if static.comm in comm_lib.PULL_KINDS and not pull:
        raise ValueError(
            f"comm={static.comm!r} is the token channel of "
            f"policy={static.comm!r}, got policy={static.policy!r}"
        )
    if static.comm == "exact" and static.network != "none":
        raise ValueError(_EXACT_OVER_NET)
    if static.transport == "ack" and static.network == "none":
        raise ValueError(
            "transport='ack' needs network='net' (instant lossless "
            "delivery has nothing to acknowledge)"
        )
    if static.policy == "sqd" and static.sqd < 1:
        raise ValueError(f"sqd must be >= 1, got {static.sqd}")
    if static.classes < 1:
        raise ValueError(f"classes must be >= 1, got {static.classes}")


def _check_diurnal_peak(static: StaticConfig, runs: Sequence[Scenario]) -> None:
    """Reject diurnal amplitudes whose modulated peak rate exceeds 1.

    ``Scenario.create`` checks this when told the arrival kind; a cell
    built without it meets its ``StaticConfig`` here.  For mmpp the peak
    is the burst state's rate ``lam_hi``, not ``load``.
    """
    amp = np.asarray([s.diurnal_amp for s in runs])
    peak = np.asarray(
        [s.lam_hi if static.arrival == "mmpp" else s.load for s in runs]
    )
    bad = (amp > 0) & (peak * (1.0 + amp) > 1.0 + 1e-6)
    if np.any(bad):
        raise ValueError(
            f"diurnal peak rate exceeds 1 for {int(np.sum(bad))} cell(s) "
            f"(arrival={static.arrival!r}: peak rate "
            f"{'lam_hi' if static.arrival == 'mmpp' else 'load'} * (1+amp) "
            f"must stay a probability)"
        )


def _check_control_plane(static: StaticConfig, runs: Sequence[Scenario]) -> None:
    """Check the runs' control-plane operands against the static kinds.

    ``Scenario.create`` checks them when told the kinds; a cell built
    without them meets its ``StaticConfig`` here.  The reference's checks
    and messages, each naming the field.
    """
    def arr(name):
        return np.asarray([getattr(scn, name) for scn in runs])

    delay, jitter, drop = arr("net_delay"), arr("net_jitter"), arr("net_drop")
    if static.network == "none":
        for name, value in (("net_delay", delay), ("net_jitter", jitter),
                            ("net_drop", drop)):
            if np.any(value != 0):
                raise ValueError(
                    f"{name} is nonzero for {int(np.sum(value != 0))} "
                    f"cell(s) but network='none'; set network='net'"
                )
        if static.fault == "none" and np.any(arr("suspect_age") > 0):
            raise ValueError(
                "suspect_age > 0 needs a modeled control plane "
                "(network='net' and/or a fault kind)"
            )
    else:
        if np.any(delay < 0) or np.any(jitter < 0):
            raise ValueError("net_delay / net_jitter must be >= 0 slots")
        if np.any(drop < 0) or np.any(drop >= 1):
            raise ValueError("net_drop is a probability and must be in [0, 1)")
        if static.policy in ("jsq", "sq2", "sqd") and np.any(
            delay >= static.net_delay_cap
        ):
            raise ValueError(
                f"net_delay must be < net_delay_cap "
                f"({static.net_delay_cap}) for the query policies' stale "
                f"state ring, got max {int(np.max(delay))}; raise "
                f"StaticConfig.net_delay_cap"
            )
    timeout, base = arr("ack_timeout"), arr("backoff_base")
    retries, ka = arr("max_retries"), arr("ka_period")
    if static.transport == "ack":
        if np.any(timeout < 1):
            raise ValueError(
                f"ack_timeout must be >= 1 slot under transport='ack' "
                f"for {int(np.sum(timeout < 1))} cell(s)"
            )
        if np.any(base < 1):
            raise ValueError(
                "backoff_base must be >= 1 (the timeout window may only "
                "grow across retries)"
            )
        if np.any(retries < 0) or np.any(ka < 0):
            raise ValueError("max_retries / ka_period must be >= 0")
    else:
        for name, value, neutral in (("ack_timeout", timeout, 0),
                                     ("backoff_base", base, 1.0),
                                     ("max_retries", retries, 0),
                                     ("ka_period", ka, 0)):
            if np.any(value != neutral):
                raise ValueError(
                    f"{name} is non-neutral for "
                    f"{int(np.sum(value != neutral))} cell(s) but "
                    f"transport='fire_forget'; set transport='ack'"
                )
    crash, recover, slow = arr("crash_rate"), arr("recover_rate"), arr("slow_factor")
    if static.fault == "none":
        for name, value, neutral in (("crash_rate", crash, 0.0),
                                     ("recover_rate", recover, 0.0),
                                     ("slow_factor", slow, 1.0)):
            if np.any(value != neutral):
                raise ValueError(
                    f"{name} is non-neutral for "
                    f"{int(np.sum(value != neutral))} cell(s) but "
                    f"fault='none'; set fault='crash' or fault='slow'"
                )
    else:
        if np.any((crash < 0) | (crash > 1)) or np.any((recover < 0) | (recover > 1)):
            raise ValueError(
                "crash_rate / recover_rate are per-slot probabilities in [0, 1]"
            )
        if np.any((crash > 0) & (recover == 0)):
            raise ValueError(
                "recover_rate must be > 0 when crash_rate > 0 (faulted "
                "servers would never recover)"
            )
        if np.any((slow <= 0) | (slow > 1)):
            raise ValueError("slow_factor must be in (0, 1]")


@dataclasses.dataclass(frozen=True)
class _Operands:
    """Per-run scenario operands: ``(N, 1)`` columns, ``horizon`` ``(N,)``,
    ``mix`` ``(N, C)``, ``rates`` ``(N, K)`` (``None``: unit rates) and
    ``aff`` ``(N, C, K)`` (``None``: unconstrained routing); the
    control-plane operands are ``(N, 1)`` columns too."""

    load: torch.Tensor
    x: torch.Tensor
    rt_period: torch.Tensor
    msr: torch.Tensor
    mean: torch.Tensor
    geo_log1p: torch.Tensor
    scale: torch.Tensor
    inv_tail: torch.Tensor
    horizon: torch.Tensor
    lam_hi: torch.Tensor
    lam_lo: torch.Tensor
    burst_stay: torch.Tensor
    amp: torch.Tensor
    period: torch.Tensor
    mix: torch.Tensor
    rates: Optional[torch.Tensor]
    aff: Optional[torch.Tensor]
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


def _operands(runs: Sequence[Scenario], static: StaticConfig, device) -> _Operands:
    """Check the runs' cells against ``static`` and stack their operands."""
    k, c = static.servers, static.classes
    for scn in runs:
        if scn.service.kind != static.service:
            raise ValueError(
                f"Scenario service kind {scn.service.kind!r} does not match "
                f"StaticConfig.service {static.service!r}"
            )
        if scn.class_mix.shape != (c,):
            raise ValueError(
                f"Scenario.class_mix has {scn.class_mix.size} classes but "
                f"StaticConfig.classes is {c}"
            )
        if scn.class_affinity is not None and scn.class_affinity.shape != (c, k):
            raise ValueError(
                f"Scenario.class_affinity must have shape (classes, servers) = "
                f"({c}, {k}), got {scn.class_affinity.shape}"
            )
        if static.use_rates and scn.service_rates is not None and (
            scn.service_rates.shape != (k,)
        ):
            raise ValueError(
                f"Scenario.service_rates must have shape ({k},), got "
                f"{scn.service_rates.shape}"
            )
        if static.policy == "hsq" and scn.rt_rate < 0:
            raise ValueError("rt_rate (the hsq token-refresh rate) must be >= 0")
    _check_diurnal_peak(static, runs)
    _check_control_plane(static, runs)

    def col(values, dtype):
        return torch.tensor(np.asarray(values), dtype=dtype, device=device)[:, None]

    def stack(values, dtype):
        return torch.tensor(np.stack(values), dtype=dtype, device=device)

    rates = aff = None
    if static.use_rates:
        ones = np.ones((k,), np.float32)
        rates = stack([ones if s.service_rates is None else s.service_rates
                       for s in runs], torch.float32)
    if static.classes > 1 or static.constrained:
        every = np.ones((c, k), bool)
        aff = stack([every if s.class_affinity is None else s.class_affinity
                     for s in runs], torch.bool)
    return _Operands(
        load=col([s.load for s in runs], torch.float32),
        x=col([s.x for s in runs], _I32),
        rt_period=col([s.rt_period for s in runs], _I32),
        msr=col([s.service.msr_slots for s in runs], _I32),
        mean=col([s.service.mean for s in runs], torch.float32),
        geo_log1p=col([s.service.geo_log1p for s in runs], torch.float32),
        scale=col([s.service.scale for s in runs], torch.float32),
        inv_tail=col([s.service.inv_tail for s in runs], torch.float32),
        horizon=col([s.horizon for s in runs], _I32)[:, 0],
        lam_hi=col([s.lam_hi for s in runs], torch.float32),
        lam_lo=col([s.lam_lo for s in runs], torch.float32),
        burst_stay=col([s.burst_stay for s in runs], torch.float32),
        amp=col([s.diurnal_amp for s in runs], torch.float32),
        period=col([s.diurnal_period for s in runs], torch.float32),
        mix=stack([s.class_mix for s in runs], torch.float32),
        rates=rates,
        aff=aff,
        **{name: col([getattr(s, name) for s in runs], dtype) for name, dtype in (
            ("net_delay", _I32), ("net_jitter", _I32), ("net_drop", torch.float32),
            ("suspect_age", _I32), ("ack_timeout", _I32),
            ("backoff_base", torch.float32), ("max_retries", _I32),
            ("ka_period", _I32), ("crash_rate", torch.float32),
            ("recover_rate", torch.float32), ("slow_factor", torch.float32),
        )},
    )


def _random_ties(static: StaticConfig) -> bool:
    return (
        static.policy in ("jsq", "jsaq") + routing_lib.PULL_POLICIES
        and not static.deterministic_ties
    )


def _subset_width(static: StaticConfig) -> int:
    """SQ(d)'s d as the reference samples it (``permutation(K)[:d]`` holds
    ``min(d, K)`` servers); 0 for the other policies."""
    if static.policy == "sq2":
        return min(2, static.servers)
    if static.policy == "sqd":
        return min(static.sqd, static.servers)
    return 0


def _control_plane(static: StaticConfig) -> bool:
    return static.network != "none" or static.fault != "none"


def _eligible(op: _Operands, classes: Optional[torch.Tensor], k: int):
    """Eligible servers of each run's arrival in every slot: ``(N, T)``
    int32 from the class affinity, or ``k`` when routing is unconstrained."""
    if op.aff is None:
        return k
    count = op.aff.sum(-1, dtype=_I32)  # (N, C)
    if classes is None:
        return count[:, :1]
    return count.gather(1, classes.long())


def draw_workload(
    seeds: Sequence[int],
    static: StaticConfig,
    scenarios: Sequence[Scenario],
    device: torch.device,
):
    """Draw ``(arrive, sizes, draws)`` for the runs ``cell * S + seed``.

    The counterpart of the reference's ``_prep``, with torch generators.
    Each seed's ``torch.Generator`` yields, in this order, the arrival
    uniforms ``(T,)``, the size uniforms ``(T,)`` (dense backend) and the
    tie-break uniforms ``(T, K)`` (random ties); after them, each only when
    its kind is on, so that every cell without these kinds replays the
    same draws: the MMPP switch uniforms ``(T,)``, the SQ(d) subsets
    ``(T, d)`` (Floyd's algorithm, O(d) draws a slot) and their tie-break
    uniforms ``(T, d)``, the random policy's float64 uniforms ``(T,)`` (under
    the control plane the two 32-bit words ``(T, 2)`` of the reference's
    ``randint`` in their place), the class uniforms ``(T,)``, then the
    control plane's: the wire's drop and
    jitter uniforms ``(T, K)`` each (``network="net"``), the ack and
    keepalive channels' ``(T, 4, K)`` (``transport="ack"``) and the fault
    chain's ``(T, K)``.  Every cell reuses its seed's uniforms.

    Returns ``(N, T)`` bool arrivals (diurnal-modulated, masked by each
    run's horizon), ``(N, T)`` int32 sizes (``None`` on the fused backend)
    and a dict of the keyword draws of :func:`run_draws`: ``gumbel``
    ``(N, T, K)``, ``subset`` ``(N, T, d)`` int32, ``subset_gumbel``
    ``(N, T, d)``, ``rand_pick`` ``(N, T)`` int32 (``floor(u *
    n_eligible)``: the class's affinity is known when the draws are made)
    or, under the control plane, ``rand_bits`` ``(N, T, 2)`` int64,
    ``classes`` ``(N, T)`` int32, ``net_drop_u`` / ``net_jit_u`` /
    ``fault_u`` ``(N, T, K)`` and ``ack_u`` ``(N, T, 4, K)`` float32, each
    present only when needed.
    """
    t, k = static.slots, static.servers
    dense = static.route_backend == "dense"
    random_ties = dense and _random_ties(static)
    d = _subset_width(static) if dense else 0
    pick = dense and static.policy == "random"
    streams: dict[str, list] = {
        "arr": [], "size": [], "gum": [], "switch": [], "subset": [],
        "subset_gum": [], "pick": [], "cls": [], "net_drop_u": [],
        "net_jit_u": [], "ack_u": [], "fault_u": [],
    }
    net = dense and static.network != "none"
    for seed in seeds:
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        streams["arr"].append(workload_lib.uniforms(gen, (t,), device=device))
        if dense:
            streams["size"].append(workload_lib.uniforms(
                gen, (t,), minval=workload_lib.SIZE_U_MIN,
                maxval=workload_lib.SIZE_U_MAX, device=device,
            ))
        if random_ties:
            streams["gum"].append(workload_lib.uniforms(
                gen, (t, k), minval=workload_lib.GUMBEL_U_MIN, device=device
            ))
        if static.arrival == "mmpp":
            streams["switch"].append(workload_lib.uniforms(gen, (t,), device=device))
        if d:
            streams["subset"].append(
                workload_lib.distinct_subsets(gen, t, k, d, device=device)
            )
            streams["subset_gum"].append(workload_lib.uniforms(
                gen, (t, d), minval=workload_lib.GUMBEL_U_MIN, device=device
            ))
        if pick and _control_plane(static):
            streams["pick"].append(torch.randint(
                0, 2**32, (t, 2), generator=gen, dtype=torch.int64, device=device
            ))
        elif pick:
            streams["pick"].append(torch.rand(
                (t,), generator=gen, dtype=torch.float64, device=device
            ))
        if static.classes > 1:
            streams["cls"].append(workload_lib.uniforms(gen, (t,), device=device))
        if net:
            for name in ("net_drop_u", "net_jit_u"):
                streams[name].append(workload_lib.uniforms(gen, (t, k), device=device))
            if static.transport == "ack":
                streams["ack_u"].append(workload_lib.uniforms(gen, (t, 4, k), device=device))
        if dense and static.fault != "none":
            streams["fault_u"].append(workload_lib.uniforms(gen, (t, k), device=device))
    runs = [scn for scn in scenarios for _ in seeds]
    op = _operands(runs, static, device)
    idx = torch.arange(len(runs), device=device) % len(seeds)

    def per_run(name):
        return torch.stack(streams[name])[idx]

    slot = torch.arange(t, device=device)
    mod = workload_lib.diurnal_modulation(slot[None, :], op.amp, op.period)
    if static.arrival == "mmpp":
        arrive = workload_lib.mmpp_arrivals_from_rates(
            per_run("switch"), per_run("arr"), op.lam_hi, op.lam_lo,
            op.burst_stay, mod,
        )
    else:
        arrive = workload_lib.bernoulli_arrivals(per_run("arr"), op.load, mod)
    arrive = arrive & (slot[None, :] < op.horizon[:, None])
    sizes = (
        workload_lib.service_sizes(
            per_run("size"), static.service, op.mean, op.geo_log1p,
            op.scale, op.inv_tail,
        )
        if dense else None
    )
    draws = {}
    if random_ties:
        draws["gumbel"] = workload_lib.gumbel(torch.stack(streams["gum"]))[idx]
    if d:
        draws["subset"] = per_run("subset")
        draws["subset_gumbel"] = workload_lib.gumbel(per_run("subset_gum"))
    if static.classes > 1:
        draws["classes"] = workload_lib.arrival_classes(per_run("cls"), op.mix)
    if pick and _control_plane(static):
        draws["rand_bits"] = per_run("pick")
    elif pick:
        n_elig = _eligible(op, draws.get("classes"), k)
        draws["rand_pick"] = torch.floor(per_run("pick") * n_elig).to(_I32).clamp(
            max=n_elig - 1
        )
    for name in ("net_drop_u", "net_jit_u", "ack_u", "fault_u"):
        if streams[name]:
            draws[name] = per_run(name)
    return arrive, sizes, draws


def _dense(arrive, sizes, static: StaticConfig, op: _Operands, *, gumbel=None,
           subset=None, subset_gumbel=None, rand_pick=None, rand_bits=None,
           classes=None, net_drop_u=None, net_jit_u=None, ack_u=None,
           fault_u=None) -> dict:
    """The port of ``_sim_core``: one slot per loop step, all runs at once."""
    n, t = arrive.shape
    k, b = static.servers, static.buffer_cap
    dev = arrive.device
    acfg = approx_lib.ApproxConfig(static.approx, msr_slots=op.msr, x=op.x)
    ccfg = comm_lib.CommConfig(static.comm, x=op.x, rt_period=op.rt_period)
    has_net = static.network != "none"
    has_ack = has_net and static.transport == "ack"
    has_fault = static.fault != "none"
    ncfg = comm_lib.NetworkConfig(
        static.network, delay=op.net_delay, jitter=op.net_jitter, drop=op.net_drop,
        transport=static.transport, ack_timeout=op.ack_timeout,
        backoff_base=op.backoff_base, max_retries=op.max_retries,
        ka_period=op.ka_period,
    )
    # Under a network the query policies route on stale queues: a ring of
    # end-of-slot snapshots read net_delay slots back (delay 0 reads the
    # previous slot's end, this slot's pre-route state).
    stale_ring = has_net and static.policy in ("jsq", "sq2", "sqd")
    cap = static.net_delay_cap
    zeros = torch.zeros((n, k), dtype=_I32, device=dev)
    zeros1 = torch.zeros((n,), dtype=_I32, device=dev)
    q_true = head_rem = head_ptr = per_srv = tokens = zeros
    buf = torch.full((n, k, b), -1, dtype=_I32, device=dev)
    emu = approx_lib.EmuState.init(zeros, acfg)
    comm, net, faulted = comm_lib.control_plane_init(
        k, network=static.network, fault=static.fault, transport=static.transport,
        batch=(n,), device=dev,
    )
    q_hist = torch.zeros((n, cap, k), dtype=_I32, device=dev) if stale_ring else None
    rr_ptr = deps = arrs = dropped = max_aq = max_q = gap = zeros1
    token_miss = token_sum = suspect_routes = masked_routes = zeros1
    comp_slot = torch.full((n, t), -1, dtype=_I32, device=dev)
    routed = torch.full((n, t), -1, dtype=_I32, device=dev)
    rows = torch.arange(n, device=dev)
    lanes = torch.arange(k, dtype=_I32, device=dev)
    slot_f = torch.arange(t, dtype=torch.float32, device=dev)
    active = torch.arange(t, device=dev)[None, :] < op.horizon[:, None]
    pull = static.policy in routing_lib.PULL_POLICIES
    sq_queries = {"sq2": 2, "sqd": static.sqd}.get(static.policy, 0) if has_net else 0
    # Expected per-job drain time E[S] / r_i, once a run.
    drain = (
        routing_lib.expected_drain_slots(op.mean, op.rates)
        if op.rates is not None and static.rate_aware else None
    )
    mask = None if op.aff is None else op.aff[:, 0]
    # Every run is frozen from its horizon on, so the loop may stop at the
    # largest one.
    t_end = min(t, max(int(op.horizon.max()), 0)) if n else 0
    for s in range(t_end):
        act = active[:, s : s + 1]
        arr = arrive[:, s] & act[:, 0]

        # 0. the fault chain advances first: this slot's service and
        # trigger see this slot's state.
        recovered = None
        if has_fault:
            adv_f, recovered = workload_lib.fault_transitions(
                faulted, fault_u[:, s], op.crash_rate, op.recover_rate)
            faulted = torch.where(act, adv_f, faulted)
            recovered = recovered & act

        # 1. arrival and routing (a class routes within its affinity, and
        # around suspect servers unless that leaves none of its own)
        q_route = q_true
        if stale_ring:
            hist = s - 1 - op.net_delay[:, 0]
            q_route = torch.where((hist >= 0)[:, None], q_hist[rows, (hist % cap).long()], 0)
        healthy = None
        if has_ack:
            # Keepalive-driven: the balancer's last-heard clock, and a
            # server that abandoned an update is a self-suspect; an
            # all-suspect fleet routes to all.
            off = op.suspect_age <= 0
            h = (off | (net.ka_age <= op.suspect_age)) & (off | ~net.gave_up)
            healthy = torch.where(h.any(-1, keepdim=True), h, True)
        elif has_net or has_fault:
            age = net.age if has_net else comm.slots_since_msg
            healthy = (op.suspect_age <= 0) | (age <= op.suspect_age)
        if classes is not None:
            mask = op.aff[rows, classes[:, s].long()]
        if healthy is None:
            route_mask = mask
        elif mask is None:
            route_mask = healthy
        else:
            both = mask & healthy
            route_mask = torch.where(both.any(-1, keepdim=True), both, mask)
        server, rr_ptr = routing_lib.route(
            static.policy, q_route, emu.q_app, rr_ptr,
            None if gumbel is None else gumbel[:, s],
            drain_slots=drain, deterministic=static.deterministic_ties,
            mask=route_mask,
            subset=None if subset is None else subset[:, s],
            subset_gumbel=None if subset_gumbel is None else subset_gumbel[:, s],
            rand_pick=None if rand_pick is None else rand_pick[:, s],
            rand_bits=None if rand_bits is None else rand_bits[:, s],
            tokens=tokens,
        )
        srv = server.long()
        onehot = lanes == server[:, None]
        if healthy is not None:
            # Arrivals routed while some but not all servers are suspect,
            # and those among them that went to a suspect server.
            partial = arr & healthy.any(-1) & ~healthy.all(-1)
            masked_routes = masked_routes + partial.to(_I32)
            suspect_routes = suspect_routes + (partial & ~healthy[rows, srv]).to(_I32)
        if pull:
            # The balancer spends a token on every routed arrival (it
            # cannot see a FIFO drop); an empty selected pool is a miss.
            token_miss = token_miss + (arr & (tokens[rows, srv] == 0)).to(_I32)
            tokens = torch.clamp_min(tokens - (onehot & arr[:, None]).to(_I32), 0)
        q_sel = q_true[rows, srv]
        admit = arr & (q_sel < b)
        dropped = dropped + (arr & ~admit).to(_I32)
        sel = onehot & admit[:, None]
        tail = ((head_ptr[rows, srv] + q_sel) % b).long()
        buf[rows, srv, tail] = torch.where(admit, s, buf[rows, srv, tail])
        head_rem = torch.where(sel & (q_true == 0), sizes[:, s : s + 1], head_rem)
        q_true = q_true + sel.to(_I32)
        emu = approx_lib.emu_arrival_masked(emu, sel, acfg)
        arrs = arrs + admit.to(_I32)
        per_srv = per_srv + sel.to(_I32)
        routed[:, s] = torch.where(admit, server, -1)

        # 2. service (one unit, or the rate's credit schedule; a crashed
        # server none, a slowed one its slowed schedule)
        units = (
            None if op.rates is None
            else workload_lib.service_units(slot_f[s], op.rates)
        )
        work = 1 if units is None else units
        if has_fault:
            work = workload_lib.faulted_service_units(
                slot_f[s], faulted, work, static.fault, op.slow_factor, rates=op.rates)
        busy = (q_true > 0) & act
        head_rem = torch.where(busy, head_rem - work, head_rem)
        dep = busy & (head_rem <= 0)
        head_jid = buf.gather(2, (head_ptr % b).long()[..., None])[..., 0]
        departed = torch.where(dep, head_jid, -1)
        q_true = torch.where(dep, q_true - 1, q_true)
        head_ptr = torch.where(dep, head_ptr + 1, head_ptr)
        next_jid = buf.gather(2, (head_ptr % b).long()[..., None])[..., 0]
        next_size = sizes.gather(1, next_jid.clamp(0, sizes.shape[1] - 1).long())
        head_rem = torch.where(dep & (q_true > 0), next_size, head_rem)
        dep_i = dep.to(_I32)
        deps = deps + dep_i.sum(-1, dtype=_I32)

        # 3. emulation drain with the nominal units (the balancer does not
        # see faults)
        emu = approx_lib.emu_drain_slot(emu, acfg, units=units, active=act)

        # 4/5. trigger (frozen past the horizon); a crashed server cannot
        # send and a recovery forces a resync.  Under a network the trigger
        # is an intent: the wire bills the messages and delivers the
        # payload that snaps the emulation.
        err = approx_lib.approximation_error(emu, q_true)
        can_send = force = None
        if static.fault == "crash":
            can_send, force = ~faulted, recovered
        triggered, adv = comm_lib.evaluate(
            comm, ccfg, err, dep_i, can_send=can_send, force=force, q=q_true,
            count_msgs=not has_net,
        )
        triggered = triggered & act
        snap_mask, snap_payload = triggered, q_true
        if has_net:
            if has_ack:
                delivered, payload, sent, net_adv = comm_lib.net_step_ack(
                    net, ncfg, triggered, q_true, net_drop_u[:, s], net_jit_u[:, s],
                    ack_u[:, s], can_send=can_send)
            else:
                delivered, payload, sent, net_adv = comm_lib.net_step(
                    net, ncfg, triggered, q_true, net_drop_u[:, s], net_jit_u[:, s],
                    can_send=can_send)
            snap_mask, snap_payload = delivered & act, payload
            net = comm_lib.select_rows(act[:, 0], net_adv, net)
            # SQ(d)'s d probes and d replies an arrival ride the wire too.
            extra = torch.where(act[:, 0], sent, 0) + sq_queries * 2 * arr.to(_I32)
            adv = dataclasses.replace(adv, msgs=adv.msgs + extra)
        comm = comm_lib.select_rows(act[:, 0], adv, comm)
        emu = approx_lib.emu_message_reset(emu, snap_payload, snap_mask, acfg)
        if pull:
            # A delivered token message overwrites its server's pool entry
            # from the queue it reports: 1 if idle (jiq), the headroom
            # below x (hsq).
            if static.comm == "jiq":
                fresh = (snap_payload == 0).to(_I32)
            else:
                fresh = torch.clamp_min(op.x - snap_payload, 0)
            tokens = torch.where(snap_mask, fresh, tokens)
            token_sum = token_sum + torch.where(
                act[:, 0], tokens.sum(-1, dtype=_I32), 0
            )

        # 6. metrics
        if stale_ring:
            q_hist[:, s % cap] = torch.where(act, q_true, q_hist[:, s % cap])
        qmax = q_true.amax(-1)
        max_aq = torch.maximum(max_aq, (q_true - emu.q_app).abs().amax(-1))
        max_q = torch.maximum(max_q, qmax)
        gap = torch.maximum(gap, qmax - q_true.amin(-1))
        valid = departed >= 0
        comp_slot.scatter_reduce_(
            1, torch.where(valid, departed, 0).long(),
            torch.where(valid, s, -1).to(_I32), "amax",
        )
    return dict(
        routed=routed, comp_slot=comp_slot, msgs=comm.msgs, deps=deps,
        arrs=arrs, dropped=dropped, max_aq=max_aq, max_q=max_q, gap_sup=gap,
        per_srv=per_srv, final_q=q_true, token_misses=token_miss,
        token_sum=token_sum,
        net_drops=zeros1 if net is None else net.drops,
        retrans=net.retrans if has_ack else zeros1,
        fault_state=torch.zeros_like(zeros, dtype=torch.bool) if faulted is None else faulted,
        suspect_routes=suspect_routes, masked_routes=masked_routes,
    )


def _fused(arrive, static: StaticConfig, op: _Operands) -> dict:
    """One ``care_route`` call for the whole run axis."""
    params = torch.cat([op.x, op.rt_period, op.msr, op.horizon[:, None]], 1)
    routed, q_final, per_srv, stats = kernel_ops.care_route(
        arrive.to(_I32).contiguous(),
        params.to(_I32).contiguous(),
        servers=static.servers,
        cap=static.buffer_cap,
        policy=static.policy,
        comm=static.comm,
    )
    zeros = torch.zeros_like(stats[:, 0])
    return dict(
        routed=routed, comp_slot=torch.full_like(routed, -1), msgs=stats[:, 0],
        deps=stats[:, 1], arrs=stats[:, 2], dropped=stats[:, 3],
        max_aq=stats[:, 4], max_q=stats[:, 5], gap_sup=stats[:, 6],
        per_srv=per_srv, final_q=q_final, token_misses=zeros, token_sum=zeros,
        net_drops=zeros, retrans=zeros,
        fault_state=torch.zeros_like(q_final, dtype=torch.bool),
        suspect_routes=zeros, masked_routes=zeros,
    )


def run_draws(
    arrive: torch.Tensor,
    sizes: torch.Tensor | None,
    static: StaticConfig,
    scenarios: Scenario | Sequence[Scenario],
    *,
    gumbel: torch.Tensor | None = None,
    subset: torch.Tensor | None = None,
    subset_gumbel: torch.Tensor | None = None,
    rand_pick: torch.Tensor | None = None,
    rand_bits: torch.Tensor | None = None,
    classes: torch.Tensor | None = None,
    net_drop_u: torch.Tensor | None = None,
    net_jit_u: torch.Tensor | None = None,
    ack_u: torch.Tensor | None = None,
    fault_u: torch.Tensor | None = None,
) -> dict:
    """Run the slot loop on given draws, one run per row.

    Args:
      arrive: ``(N, T)`` bool arrival indicators (masked by the horizon).
      sizes: ``(N, T)`` int32 job sizes (the dense backend reads them).
      static: shapes, kinds and backend.
      scenarios: one :class:`Scenario` for every row, or ``N`` of them.
      gumbel: ``(N, T, K)`` float32 tie-break Gumbels; required by the
        dense backend for jsq / jsaq / jiq / hsq with random ties.
      subset: ``(N, T, d)`` int32 SQ(d) samples of distinct servers, with
        ``d = min(2 or sqd, K)``; required by sq2 / sqd.
      subset_gumbel: ``(N, T, d)`` float32 Gumbels breaking ties within
        each subset; required with ``subset``.
      rand_pick: ``(N, T)`` int32 draws in ``[0, n_eligible)`` of the
        random policy (``n_eligible`` the servers of the slot's class).
      rand_bits: ``(N, T, 2)`` int64 words of the random policy under the
        control plane, whose suspect mask sets each slot's eligible count
        (``routing.randint_from_bits``); required there in place of
        ``rand_pick``.
      classes: ``(N, T)`` int32 arrival class ids; required when
        ``static.classes > 1``.
      net_drop_u / net_jit_u: ``(N, T, K)`` float32 uniforms of the wire's
        drop and jitter draws; required by ``network="net"``.
      ack_u: ``(N, T, 4, K)`` float32 uniforms of the ack and keepalive
        channels (ack drop, ack jitter, keepalive drop, keepalive jitter);
        required by ``transport="ack"``.
      fault_u: ``(N, T, K)`` float32 uniforms of the fault chain; required
        by a fault kind.

    Returns a dict of per-run tensors: ``routed`` ``(N, T)`` (-1 where no
    arrival was admitted), ``comp_slot`` ``(N, T)`` (the completion slot
    of the job that arrived in each slot, -1 if none), the counters
    ``msgs``, ``deps``, ``arrs``, ``dropped``, ``max_aq``, ``max_q``,
    ``gap_sup``, ``token_misses``, ``token_sum``, ``net_drops``,
    ``retrans`` ``(N,)``, the vectors ``per_srv``, ``final_q`` ``(N, K)``
    and the end-of-run fault mask ``fault_state`` ``(N, K)``.  Under a
    suspect mask, ``masked_routes`` counts the arrivals routed while some
    but not all servers were suspect and ``suspect_routes`` those of them
    that went to a suspect server ``(N,)``.
    """
    _check_static(static)
    n, t = arrive.shape
    runs = [scenarios] * n if isinstance(scenarios, Scenario) else list(scenarios)
    if len(runs) != n:
        raise ValueError(f"{len(runs)} scenarios for {n} runs")
    op = _operands(runs, static, arrive.device)
    if static.route_backend == "fused":
        return _fused(arrive, static, op)
    if sizes is None:
        raise ValueError("the dense backend needs the job sizes")
    if _random_ties(static) and gumbel is None:
        raise ValueError("random ties need the (N, T, K) Gumbel draws")
    d = _subset_width(static)
    if d and (subset is None or subset_gumbel is None
              or subset.shape != (n, t, d) or subset_gumbel.shape != (n, t, d)):
        raise ValueError(
            f"policy {static.policy!r} needs the (N, T, d) = ({n}, {t}, {d}) "
            f"subset and subset_gumbel draws"
        )
    if static.policy == "random" and _control_plane(static):
        if rand_bits is None or tuple(rand_bits.shape) != (n, t, 2):
            raise ValueError("policy 'random' under the control plane needs the "
                             "(N, T, 2) rand_bits draws")
    elif static.policy == "random" and rand_pick is None:
        raise ValueError("policy 'random' needs the (N, T) rand_pick draws")
    if static.classes > 1 and classes is None:
        raise ValueError("multi-class arrivals need the (N, T) class ids")
    k = static.servers
    for name, value, shape, needed in (
        ("net_drop_u", net_drop_u, (n, t, k), static.network != "none"),
        ("net_jit_u", net_jit_u, (n, t, k), static.network != "none"),
        ("ack_u", ack_u, (n, t, 4, k), static.transport == "ack"),
        ("fault_u", fault_u, (n, t, k), static.fault != "none"),
    ):
        if needed and (value is None or tuple(value.shape) != shape):
            raise ValueError(f"the control plane needs the {shape} {name} draws")
    return _dense(
        arrive, sizes, static, op, gumbel=gumbel, subset=subset,
        subset_gumbel=subset_gumbel, rand_pick=rand_pick, rand_bits=rand_bits,
        classes=classes if static.classes > 1 else None,
        net_drop_u=net_drop_u, net_jit_u=net_jit_u, ack_u=ack_u, fault_u=fault_u,
    )


def _finalize(arrive_np: np.ndarray, out: dict) -> SimResult:
    """One run's host outputs as a :class:`SimResult`."""
    arrival_slots = np.nonzero(arrive_np)[0]
    comp = out["comp_slot"][arrival_slots]
    done = comp >= 0
    jct = comp[done] - arrival_slots[done] + 1
    deps = int(out["deps"])
    msgs = int(out["msgs"])
    return SimResult(
        jct=jct.astype(np.int64),
        arrivals=int(out["arrs"]),
        departures=deps,
        messages=msgs,
        max_aq=int(out["max_aq"]),
        max_queue=int(out["max_q"]),
        overflow=bool(out["dropped"] > 0),
        per_server_arrivals=out["per_srv"],
        final_q=out["final_q"],
        msgs_per_departure=(msgs / deps) if deps else 0.0,
        queue_gap_sup=int(out["gap_sup"]),
        dropped=int(out["dropped"]),
        net_drops=int(out["net_drops"]),
        retrans=int(out["retrans"]),
        token_misses=int(out["token_misses"]),
        token_sum=int(out["token_sum"]),
    )


def results(arrive: torch.Tensor, raw: dict) -> list[SimResult]:
    """Per-run :class:`SimResult` list from :func:`run_draws` outputs."""
    arrive_np = arrive.cpu().numpy()
    host = {name: v.cpu().numpy() for name, v in raw.items()}
    return [
        _finalize(arrive_np[i], {name: v[i] for name, v in host.items()})
        for i in range(arrive_np.shape[0])
    ]


def _resolve_device(device) -> torch.device:
    """``None`` means the CUDA card; a missing card is an error, never a
    silent fallback to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch path on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def simulate_grid(
    seeds: Sequence[int],
    static_cfg: StaticConfig,
    scenarios: Sequence[Scenario],
    *,
    device: str | torch.device | None = None,
) -> list[list[SimResult]]:
    """Run a whole scenario grid as one batched run axis.

    Every cell replays the same seeds; the runs are flattened cell-major
    (``run = cell * S + seed``) and advance together, through the dense
    loop or one fused kernel call.  Returns ``results[c][s]``.
    ``device=None`` means the CUDA card; pass ``device="cpu"`` for the
    plain PyTorch path.
    """
    dev = _resolve_device(device)
    _check_static(static_cfg)
    seeds = [int(s) for s in seeds]
    scenarios = list(scenarios)
    arrive, sizes, draws = draw_workload(seeds, static_cfg, scenarios, dev)
    runs = [scn for scn in scenarios for _ in seeds]
    res = results(arrive, run_draws(arrive, sizes, static_cfg, runs, **draws))
    s = len(seeds)
    return [res[c * s : (c + 1) * s] for c in range(len(scenarios))]


def simulate_batch(
    seeds: Sequence[int], cfg: SimConfig, *, device=None
) -> list[SimResult]:
    """One cell over a batch of seeds (the one-cell case of the grid)."""
    return simulate_grid(seeds, cfg.static_part(), [cfg.scenario()], device=device)[0]


def simulate(seed: int, cfg: SimConfig, *, device=None) -> SimResult:
    """One slotted simulation of one cell and one seed."""
    return simulate_batch([seed], cfg, device=device)[0]


def exact_state_messages(result: SimResult, policy: str, sqd: int = 2,
                         network: str = "none") -> int:
    """Messages the *policy itself* fundamentally needs (paper Fig. 5).

    JSQ needs one message per departure; SQ(d) needs 2d per arrival under
    the query implementation (already in ``result.messages`` under a
    network, where they are billed on the wire); RR / Random need none.
    CARE policies report their trigger-counted messages directly.
    """
    if policy == "jsq":
        return result.departures
    if policy in ("sq2", "sqd") and network != "none":
        return result.messages
    if policy == "sq2":
        return 4 * result.arrivals
    if policy == "sqd":
        return 2 * sqd * result.arrivals
    if policy in ("rr", "random"):
        return 0
    return result.messages
