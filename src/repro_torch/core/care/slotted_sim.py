"""Discrete-time slotted simulator for the CARE model (paper Section 9).

Port of ``repro/core/care/slotted_sim.py``.  K parallel FIFO servers and one
load balancer; in every slot, in this order:

  1. a Bernoulli(``load``) arrival is routed on the *pre-slot* state (a
     full FIFO, ``q >= buffer_cap``, drops it and counts the drop);
  2. every busy server works one unit; the head job departs when its
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
and per-slot tie-break Gumbels from one ``torch.Generator`` per seed, and
every cell replays the same uniforms for the same seed.  :func:`run_draws`
takes those draws as tensors, so a caller (the tests) can feed it the
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

The network, fault, class and pull kinds, the SQ(d) / random policies, MMPP
arrivals and the heavy-tailed sizes come with slice 2 of the port and
raise ``NotImplementedError`` here.
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
_SLICE_2 = "slice 2 of the port (ROADMAP 1, item {})"


@dataclasses.dataclass(frozen=True)
class StaticConfig:
    """Shapes and kinds of a simulator run (hashable).

    ``slots`` is the padded loop length; each cell's effective length is
    its ``Scenario.horizon``.  ``route_backend`` is ``"dense"`` or
    ``"fused"``; ``deterministic_ties`` breaks shortest-queue ties to the
    lowest index instead of uniformly at random (the fused kernel's rule).
    """

    servers: int = 30
    slots: int = 100_000
    policy: str = "jsaq"
    comm: str = "et"
    approx: str = "msr"
    buffer_cap: int = 2048
    arrival: str = "bernoulli"
    service: str = "geometric"
    use_rates: bool = False
    route_backend: str = "dense"
    deterministic_ties: bool = False
    network: str = "none"
    fault: str = "none"
    classes: int = 1


@dataclasses.dataclass(frozen=True)
class Scenario:
    """Numeric operands of one grid cell, float32 / int32 as the reference
    carries them.  ``rt_period`` is derived from ``rt_rate`` host-side."""

    load: np.float32
    x: np.int32
    rt_rate: np.float32
    rt_period: np.int32
    service: workload_lib.ServiceProcess
    horizon: np.int32

    @staticmethod
    def create(
        load: float,
        x: int = 3,
        rt_rate: float = 0.01,
        mean_service: float = 30,
        service: str = "geometric",
        horizon: Optional[int] = None,
    ) -> "Scenario":
        period = max(int(round(1.0 / max(rt_rate, 1e-9))), 1)
        if horizon is None:
            horizon = np.iinfo(np.int32).max  # unbounded: never mask
        return Scenario(
            load=np.float32(load),
            x=np.int32(x),
            rt_rate=np.float32(rt_rate),
            rt_period=np.int32(period),
            service=workload_lib.ServiceProcess.create(
                kind=service, mean=mean_service
            ),
            horizon=np.int32(horizon),
        )


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """One grid cell as the user sees it: :meth:`static_part` + :meth:`scenario`.

    ``service_rates``, ``class_mix``, ``network`` and ``fault`` name
    features of slice 2; any value other than the default is refused.
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
    arrival: str = "bernoulli"
    service: str = "geometric"
    service_rates: Optional[tuple] = None
    max_slots: Optional[int] = None
    route_backend: str = "dense"
    deterministic_ties: bool = False
    network: str = "none"
    fault: str = "none"
    class_mix: Optional[tuple] = None

    def static_part(self) -> StaticConfig:
        if self.max_slots is not None and self.max_slots < self.slots:
            raise ValueError(
                f"max_slots ({self.max_slots}) must be >= slots ({self.slots})"
            )
        return StaticConfig(
            servers=self.servers,
            slots=self.max_slots if self.max_slots is not None else self.slots,
            policy=self.policy,
            comm=self.comm,
            approx=self.approx,
            buffer_cap=self.buffer_cap,
            arrival=self.arrival,
            service=self.service,
            use_rates=self.service_rates is not None,
            route_backend=self.route_backend,
            deterministic_ties=self.deterministic_ties,
            network=self.network,
            fault=self.fault,
            classes=len(self.class_mix) if self.class_mix is not None else 1,
        )

    def scenario(self) -> Scenario:
        return Scenario.create(
            load=self.load,
            x=self.x,
            rt_rate=self.rt_rate,
            mean_service=self.mean_service,
            service=self.service,
            horizon=self.slots,
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


def _check_fused_static(static: StaticConfig) -> None:
    """Refuse what the fused kernel does not model, exactly as the
    reference's ``_check_pallas_static`` refuses it: shortest-queue routing
    with lowest-index ties, MSR emulation, deterministic jobs at unit
    rates, no control-plane model and no routing constraints."""
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
            f"fault={static.fault!r}) -- use route_backend='dense'"
        )
    if static.classes > 1:
        raise NotImplementedError(
            f"route_backend='fused' does not implement constrained routing "
            f"(classes={static.classes}) -- use route_backend='dense'"
        )


def _check_static(static: StaticConfig) -> None:
    """Refuse kinds this slice does not run, naming the slice that will."""
    if static.route_backend not in ("dense", "fused"):
        raise ValueError(
            f"route_backend must be 'dense' or 'fused', got {static.route_backend!r}"
        )
    if static.route_backend == "fused":
        _check_fused_static(static)
    if static.network != "none" or static.fault != "none":
        raise NotImplementedError(
            f"network={static.network!r} / fault={static.fault!r} come with "
            + _SLICE_2.format(9)
        )
    if static.classes > 1:
        raise NotImplementedError(
            f"multi-class arrivals come with {_SLICE_2.format(10)}"
        )
    if static.policy in ("jiq", "hsq") or static.comm in comm_lib.PULL_KINDS:
        raise NotImplementedError(
            f"pull policies and comm kinds come with {_SLICE_2.format(10)}"
        )
    if static.policy in ("sq2", "sqd", "random"):
        raise NotImplementedError(
            f"policy {static.policy!r} comes with {_SLICE_2.format(8)}"
        )
    if static.arrival == "mmpp":
        raise NotImplementedError(f"MMPP arrivals come with {_SLICE_2.format(8)}")
    if static.service in ("pareto", "weibull"):
        raise NotImplementedError(
            f"service kind {static.service!r} comes with {_SLICE_2.format(8)}"
        )
    if static.use_rates:
        raise NotImplementedError(
            f"heterogeneous service rates come with {_SLICE_2.format(8)}"
        )
    for name, value, allowed in (
        ("policy", static.policy, ("jsq", "jsaq", "rr")),
        ("comm", static.comm, comm_lib.PUSH_KINDS),
        ("approx", static.approx, ("basic", "msr", "msr_x")),
        ("arrival", static.arrival, ("bernoulli",)),
        ("service", static.service, ("geometric", "deterministic")),
    ):
        if value not in allowed:
            raise ValueError(f"unknown {name}: {value!r}")


@dataclasses.dataclass(frozen=True)
class _Operands:
    """Per-run scenario operands: ``(N, 1)`` columns, ``horizon`` ``(N,)``."""

    load: torch.Tensor
    x: torch.Tensor
    rt_period: torch.Tensor
    msr: torch.Tensor
    mean: torch.Tensor
    geo_log1p: torch.Tensor
    horizon: torch.Tensor


def _operands(runs: Sequence[Scenario], static: StaticConfig, device) -> _Operands:
    for scn in runs:
        if scn.service.kind != static.service:
            raise ValueError(
                f"Scenario service kind {scn.service.kind!r} does not match "
                f"StaticConfig.service {static.service!r}"
            )

    def col(values, dtype):
        return torch.tensor(np.asarray(values), dtype=dtype, device=device)[:, None]

    return _Operands(
        load=col([s.load for s in runs], torch.float32),
        x=col([s.x for s in runs], _I32),
        rt_period=col([s.rt_period for s in runs], _I32),
        msr=col([s.service.msr_slots for s in runs], _I32),
        mean=col([s.service.mean for s in runs], torch.float32),
        geo_log1p=col([s.service.geo_log1p for s in runs], torch.float32),
        horizon=col([s.horizon for s in runs], _I32)[:, 0],
    )


def _random_ties(static: StaticConfig) -> bool:
    return static.policy in ("jsq", "jsaq") and not static.deterministic_ties


def draw_workload(
    seeds: Sequence[int],
    static: StaticConfig,
    scenarios: Sequence[Scenario],
    device: torch.device,
):
    """Draw ``(arrive, sizes, gumbel)`` for the runs ``cell * S + seed``.

    The counterpart of the reference's ``_prep``, with torch generators.

    Each seed's ``torch.Generator`` yields, in this order, the arrival
    uniforms ``(T,)``, the size uniforms ``(T,)`` (dense backend) and the
    tie-break uniforms ``(T, K)`` (random ties), and every cell reuses its
    seed's uniforms.  Returns ``(N, T)`` bool arrivals masked by each run's
    horizon, ``(N, T)`` int32 sizes (``None`` on the fused backend) and
    ``(N, T, K)`` float32 Gumbels (``None`` unless ties are random).
    """
    t, k = static.slots, static.servers
    dense = static.route_backend == "dense"
    random_ties = dense and _random_ties(static)
    u_arr, u_size, u_gum = [], [], []
    for seed in seeds:
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        u_arr.append(workload_lib.uniforms(gen, (t,), device=device))
        if dense:
            u_size.append(workload_lib.uniforms(
                gen, (t,), minval=workload_lib.SIZE_U_MIN,
                maxval=workload_lib.SIZE_U_MAX, device=device,
            ))
        if random_ties:
            u_gum.append(workload_lib.uniforms(
                gen, (t, k), minval=workload_lib.GUMBEL_U_MIN, device=device
            ))
    runs = [scn for scn in scenarios for _ in seeds]
    op = _operands(runs, static, device)
    idx = torch.arange(len(runs), device=device) % len(seeds)
    slot = torch.arange(t, device=device)
    arrive = workload_lib.bernoulli_arrivals(torch.stack(u_arr)[idx], op.load)
    arrive = arrive & (slot[None, :] < op.horizon[:, None])
    sizes = (
        workload_lib.service_sizes(
            torch.stack(u_size)[idx], static.service, op.mean, op.geo_log1p
        )
        if dense else None
    )
    gum = workload_lib.gumbel(torch.stack(u_gum))[idx] if random_ties else None
    return arrive, sizes, gum


def _dense(arrive, sizes, gumbel, static: StaticConfig, op: _Operands) -> dict:
    """The port of ``_sim_core``: one slot per loop step, all runs at once."""
    n, t = arrive.shape
    k, b = static.servers, static.buffer_cap
    dev = arrive.device
    acfg = approx_lib.ApproxConfig(static.approx, msr_slots=op.msr, x=op.x)
    ccfg = comm_lib.CommConfig(static.comm, x=op.x, rt_period=op.rt_period)
    zeros = torch.zeros((n, k), dtype=_I32, device=dev)
    zeros1 = torch.zeros((n,), dtype=_I32, device=dev)
    q_true = head_rem = head_ptr = per_srv = zeros
    buf = torch.full((n, k, b), -1, dtype=_I32, device=dev)
    emu = approx_lib.EmuState.init(zeros, acfg)
    comm = comm_lib.CommState.init(k, (n,), dev)
    rr_ptr = deps = arrs = dropped = max_aq = max_q = gap = zeros1
    comp_slot = torch.full((n, t), -1, dtype=_I32, device=dev)
    routed = torch.full((n, t), -1, dtype=_I32, device=dev)
    rows = torch.arange(n, device=dev)
    lanes = torch.arange(k, dtype=_I32, device=dev)
    active = torch.arange(t, device=dev)[None, :] < op.horizon[:, None]
    # Every run is frozen from its horizon on, so the loop may stop at the
    # largest one.
    t_end = min(t, max(int(op.horizon.max()), 0)) if n else 0
    for s in range(t_end):
        act = active[:, s : s + 1]
        arr = arrive[:, s] & act[:, 0]

        # 1. arrival and routing
        server, rr_ptr = routing_lib.route(
            static.policy, q_true, emu.q_app, rr_ptr,
            None if gumbel is None else gumbel[:, s],
            deterministic=static.deterministic_ties,
        )
        srv = server.long()
        onehot = lanes == server[:, None]
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

        # 2. service
        busy = (q_true > 0) & act
        head_rem = torch.where(busy, head_rem - 1, head_rem)
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

        # 3. emulation drain
        emu = approx_lib.emu_drain_slot(emu, acfg, active=act)

        # 4/5. trigger (frozen past the horizon) and snap
        err = approx_lib.approximation_error(emu, q_true)
        triggered, adv = comm_lib.evaluate(comm, ccfg, err, dep_i)
        triggered = triggered & act
        comm = comm_lib.CommState(
            deps_since_msg=torch.where(act, adv.deps_since_msg, comm.deps_since_msg),
            slots_since_msg=torch.where(act, adv.slots_since_msg, comm.slots_since_msg),
            msgs=torch.where(act[:, 0], adv.msgs, comm.msgs),
        )
        emu = approx_lib.emu_message_reset(emu, q_true, triggered, acfg)

        # 6. metrics
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
        per_srv=per_srv, final_q=q_true,
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
    return dict(
        routed=routed, comp_slot=torch.full_like(routed, -1), msgs=stats[:, 0],
        deps=stats[:, 1], arrs=stats[:, 2], dropped=stats[:, 3],
        max_aq=stats[:, 4], max_q=stats[:, 5], gap_sup=stats[:, 6],
        per_srv=per_srv, final_q=q_final,
    )


def run_draws(
    arrive: torch.Tensor,
    sizes: torch.Tensor | None,
    static: StaticConfig,
    scenarios: Scenario | Sequence[Scenario],
    *,
    gumbel: torch.Tensor | None = None,
) -> dict:
    """Run the slot loop on given draws, one run per row.

    Args:
      arrive: ``(N, T)`` bool arrival indicators (masked by the horizon).
      sizes: ``(N, T)`` int32 job sizes (the dense backend reads them).
      static: shapes, kinds and backend.
      scenarios: one :class:`Scenario` for every row, or ``N`` of them.
      gumbel: ``(N, T, K)`` float32 tie-break Gumbels; required by the
        dense backend for jsq/jsaq with random ties.

    Returns a dict of per-run tensors: ``routed`` ``(N, T)`` (-1 where no
    arrival was admitted), ``comp_slot`` ``(N, T)`` (the completion slot
    of the job that arrived in each slot, -1 if none), the counters
    ``msgs``, ``deps``, ``arrs``, ``dropped``, ``max_aq``, ``max_q``,
    ``gap_sup`` ``(N,)`` and the vectors ``per_srv``, ``final_q`` ``(N, K)``.
    """
    _check_static(static)
    n = arrive.shape[0]
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
    return _dense(arrive, sizes, gumbel, static, op)


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
    arrive, sizes, gum = draw_workload(seeds, static_cfg, scenarios, dev)
    runs = [scn for scn in scenarios for _ in seeds]
    res = results(arrive, run_draws(arrive, sizes, static_cfg, runs, gumbel=gum))
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


def exact_state_messages(result: SimResult, policy: str, sqd: int = 2) -> int:
    """Messages the *policy itself* fundamentally needs (paper Fig. 5).

    JSQ needs one message per departure; SQ(d) needs 2d per arrival under
    the query implementation; RR / Random need none.  CARE policies report
    their trigger-counted messages directly.
    """
    if policy == "jsq":
        return result.departures
    if policy == "sq2":
        return 4 * result.arrivals
    if policy == "sqd":
        return 2 * sqd * result.arrivals
    if policy in ("rr", "random"):
        return 0
    return result.messages
