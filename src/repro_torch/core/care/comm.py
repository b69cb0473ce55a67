"""Communication component of the CARE model: the trigger core.

Port of ``repro/core/care/comm.py:87-265`` for the push kinds:

* ``rt``     -- a message every ``rt_period`` slots;
* ``dt``     -- a message after every ``x`` departures;
* ``et``     -- a message as soon as the approximation error reaches ``x``;
* ``et_rt``  -- ``et`` with an ``rt`` fallback after ``rt_period`` silent
  slots;
* ``exact``  -- one message per departure (Prop 6.1);
* ``none``   -- never;

and the pull kinds, where a server pushes a token to the balancer:

* ``jiq``    -- when this slot's departures left its queue empty;
* ``hsq``    -- when its queue drops below ``x`` (a downward crossing), or
  after ``rt_period`` silent slots (the token refresh).

Both pull kinds carry the push kinds' payload (the sender's exact queue
length), so the tokens ride :func:`net_step` unchanged.

The degraded control plane (port of ``repro/core/care/comm.py:267-1004``):
with ``network="net"`` every server->balancer message goes through
:func:`net_step` (fire-and-forget: delay, jitter, drop, piggyback) or, with
``transport="ack"``, :func:`net_step_ack` (timeout windows, exponential
backoff, fresh-snapshot retransmits, abandonment, acks and keepalives
billed on the same wire).  :func:`control_plane_init` builds the carries,
:func:`snapshot_state` / :func:`restore_state` move them to and from the
host with int64 counters, and :func:`validate_control_plane` rejects
invalid operands with the reference's messages.

Functions are vectorised over a trailing server axis and any leading batch
axes (the simulator's run axis).  Numeric operands (``x``, ``rt_period``,
the network's ``delay`` ... ``ka_period``) may be numbers or tensors
broadcastable against the per-server state (one per run); the scalar
totals (``msgs``, ``drops``, ``retrans``) carry the batch shape.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Literal, Tuple

import numpy as np
import torch

CommKind = Literal["none", "rt", "dt", "et", "et_rt", "exact", "jiq", "hsq"]
NetworkKind = Literal["none", "net"]
TransportKind = Literal["fire_forget", "ack"]

PUSH_KINDS = ("none", "rt", "dt", "et", "et_rt", "exact")
# Server-initiated (pull) kinds; each pairs 1:1 with the routing policy of
# the same name.
PULL_KINDS = ("jiq", "hsq")
_I32_MAX = int(np.iinfo(np.int32).max)


@dataclasses.dataclass(frozen=True)
class CommConfig:
    """Trigger kind plus its numeric thresholds (numbers or tensors)."""

    kind: CommKind = "et"
    x: Any = 3
    rt_period: Any = 100

    @staticmethod
    def from_rate(kind: CommKind, x=3, rt_rate: float = 0.01) -> "CommConfig":
        """Build a config from a per-slot message *rate* (RT-r convention)."""
        period = max(int(round(1.0 / max(rt_rate, 1e-9))), 1)
        return CommConfig(kind=kind, x=x, rt_period=period)


@dataclasses.dataclass
class CommState:
    """Per-server trigger counters ``(..., K)`` and the message total ``(...)``."""

    deps_since_msg: torch.Tensor
    slots_since_msg: torch.Tensor
    msgs: torch.Tensor

    COUNTERS = ("msgs",)  # running totals (see snapshot_state)

    @staticmethod
    def init(k: int, batch: tuple = (), device=None) -> "CommState":
        zeros = torch.zeros((*batch, k), dtype=torch.int32, device=device)
        return CommState(
            deps_since_msg=zeros,
            slots_since_msg=zeros.clone(),
            msgs=torch.zeros(batch, dtype=torch.int32, device=device),
        )


def trigger(
    cfg: CommConfig,
    *,
    err=None,
    deps_since=None,
    slots_since=None,
    new_deps=None,
    q=None,
) -> torch.Tensor:
    """Pure trigger predicate on already-advanced counters.

    ``q`` is the end-of-slot queue length the pull kinds key on.
    """
    if cfg.kind == "rt":
        return slots_since >= cfg.rt_period
    if cfg.kind == "dt":
        return deps_since >= cfg.x
    if cfg.kind == "et":
        return err >= cfg.x
    if cfg.kind == "et_rt":
        return (err >= cfg.x) | (slots_since >= cfg.rt_period)
    if cfg.kind == "exact":
        return new_deps > 0
    if cfg.kind == "jiq":
        return (new_deps > 0) & (q == 0)
    if cfg.kind == "hsq":
        return ((q < cfg.x) & (q + new_deps >= cfg.x)) | (
            slots_since >= cfg.rt_period
        )
    if cfg.kind == "none":
        return torch.zeros_like(deps_since, dtype=torch.bool)
    raise ValueError(f"unknown communication kind: {cfg.kind}")


def evaluate(
    state: CommState,
    cfg: CommConfig,
    err: torch.Tensor,
    new_deps: torch.Tensor,
    *,
    can_send: torch.Tensor | None = None,
    force: torch.Tensor | None = None,
    q: torch.Tensor | None = None,
    count_msgs: bool = True,
) -> Tuple[torch.Tensor, CommState]:
    """Advance the pattern by one slot and evaluate the trigger.

    This slot's departures and the elapsed slot are counted *before* the
    comparison, so a message fires in the slot its condition is met
    (Theorem 2.3's ``AQ <= x-1``).  ``force`` (servers that must send) is
    applied before ``can_send`` (servers able to send).  ``q`` is the
    end-of-slot queue length, read by the pull kinds only.  With
    ``count_msgs=False`` the trigger intent is returned and ``msgs`` is
    left as it was.  ``exact`` bills one message per departure, even when
    several departures share a slot.

    Returns ``(triggered, state')``: the ``(..., K)`` bool mask of senders
    and the state with their counters reset and ``msgs`` accumulated.
    """
    deps_since = state.deps_since_msg + new_deps
    slots_since = state.slots_since_msg + 1
    triggered = trigger(
        cfg,
        err=err,
        deps_since=deps_since,
        slots_since=slots_since,
        new_deps=new_deps,
        q=q,
    )
    if force is not None:
        triggered = triggered | force
    if can_send is not None:
        triggered = triggered & can_send

    if not count_msgs:
        sent = torch.zeros_like(state.msgs)
    elif cfg.kind == "exact":
        sent = new_deps.sum(-1, dtype=torch.int32)
    else:
        sent = triggered.sum(-1, dtype=torch.int32)

    return triggered, CommState(
        deps_since_msg=torch.where(triggered, 0, deps_since),
        slots_since_msg=torch.where(triggered, 0, slots_since),
        msgs=state.msgs + sent,
    )




@dataclasses.dataclass(frozen=True)
class NetworkConfig:
    """Control-plane network: static ``kind`` / ``transport``, numeric operands.

    ``delay`` (slots), ``jitter`` (extra uniform delay in ``[0, jitter]``)
    and ``drop`` (i.i.d. loss probability) shape the wire; under
    ``transport="ack"``, ``ack_timeout`` (the first window), ``backoff_base``
    (its multiplier per retransmit), ``max_retries`` and ``ka_period`` (0 =
    no keepalives) drive :func:`net_step_ack`.  Each operand is a number or
    a tensor (int32, or float32 for ``drop`` / ``backoff_base``).
    """

    kind: NetworkKind = "none"
    delay: Any = 0
    jitter: Any = 0
    drop: Any = 0.0
    transport: TransportKind = "fire_forget"
    ack_timeout: Any = 0
    backoff_base: Any = 1.0
    max_retries: Any = 0
    ka_period: Any = 0


def _as(value, dtype, like: torch.Tensor) -> torch.Tensor:
    """``value`` (a number or tensor) as a ``dtype`` tensor on ``like``'s device."""
    return torch.as_tensor(value, dtype=dtype, device=like.device)


@dataclasses.dataclass
class NetState:
    """Fire-and-forget wire state: ``(..., K)`` per server, ``drops`` ``(...)``.

    ``timer`` counts down to delivery (-1 = nothing in flight), ``payload``
    is the snapshot taken at send time, ``pending`` a trigger queued behind
    the in-flight message (piggybacked), ``age`` the slots since the
    balancer last received an update, ``drops`` the messages lost.
    """

    timer: torch.Tensor
    payload: torch.Tensor
    pending: torch.Tensor
    age: torch.Tensor
    drops: torch.Tensor

    COUNTERS = ("drops",)

    @staticmethod
    def init(k: int, batch: tuple = (), device=None,
             payload_dtype=torch.int32) -> "NetState":
        shape = (*batch, k)
        return NetState(
            timer=torch.full(shape, -1, dtype=torch.int32, device=device),
            payload=torch.zeros(shape, dtype=payload_dtype, device=device),
            pending=torch.zeros(shape, dtype=torch.bool, device=device),
            age=torch.zeros(shape, dtype=torch.int32, device=device),
            drops=torch.zeros(batch, dtype=torch.int32, device=device),
        )


def _wire(send, drop_u, jit_u, cfg: NetworkConfig):
    """One channel's draws: ``(lost, instant, flying, total_delay)``.

    A send is lost when ``drop_u < drop``; a survivor takes ``delay +
    floor(jit_u * (jitter + 1))`` slots (a float32 product truncated to
    int32), delivering in this slot when that is 0.
    """
    lost = send & (drop_u < _as(cfg.drop, torch.float32, drop_u))
    extra = (jit_u * _as(cfg.jitter + 1, torch.float32, jit_u)).to(torch.int32)
    total_delay = _as(cfg.delay, torch.int32, jit_u) + extra
    enq = send & ~lost
    return lost, enq & (total_delay == 0), enq & (total_delay > 0), total_delay


def net_step(
    state: NetState,
    cfg: NetworkConfig,
    triggered: torch.Tensor,
    payload_now: torch.Tensor,
    drop_u: torch.Tensor,
    jit_u: torch.Tensor,
    can_send: torch.Tensor | None = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, NetState]:
    """Advance the fire-and-forget wire one slot (the reference's order).

    1. in-flight messages with ``timer == 0`` are due;
    2. a server whose channel is free (idle or due) sends on a trigger or
       a pending piggyback, snapshotting ``payload_now``;
    3. each send costs one message and is lost with probability ``drop``;
    4. a survivor with zero total delay delivers this slot (the instant
       path: a zero-operand ``net`` cell equals ``none``), the others fly;
    5. due and instant messages deliver; ``age`` resets there.

    ``can_send`` (``False`` for a crashed server) suppresses its send and
    wipes its pending piggyback.  Returns ``(delivered, out_payload, sent,
    state')``: the delivered mask, the payload to apply there, and the
    messages put on the wire ``(...)`` int32.
    """
    in_flight = state.timer >= 0
    due = in_flight & (state.timer == 0)
    free = ~in_flight | due
    send = (triggered | state.pending) & free
    if can_send is not None:
        send = send & can_send
    pending = (state.pending | triggered) & ~send
    if can_send is not None:
        pending = pending & can_send
    lost, instant, flying, total_delay = _wire(send, drop_u, jit_u, cfg)
    delivered = due | instant
    # On a handoff slot (a due delivery as a new send goes out) the due
    # message's payload is delivered and the new send's is stored: the
    # stored payload must be read before it is overwritten.
    out_payload = torch.where(instant, payload_now, state.payload)
    stored = torch.where(flying | instant, payload_now, state.payload)
    timer = torch.where(
        flying, total_delay - 1,
        torch.where(in_flight & ~due, state.timer - 1, -1),
    ).to(torch.int32)
    return delivered, out_payload, send.sum(-1, dtype=torch.int32), NetState(
        timer=timer,
        payload=stored,
        pending=pending,
        age=torch.where(delivered, 0, state.age + 1).to(torch.int32),
        drops=state.drops + lost.sum(-1, dtype=torch.int32),
    )


@dataclasses.dataclass
class AckNetState:
    """Reliable-transport wire state, ``(..., K)`` per server.

    Three single-slot channels a server (a newer message supersedes an
    older one in flight): data (``timer`` / ``payload`` / ``pending`` as in
    :class:`NetState`), acks (``ack_timer``) and keepalives (``ka_timer``,
    fired every ``ka_period`` slots by the sender clock ``ka_since``).
    ``awaiting`` counts down the open timeout window (-1 = none),
    ``backoff`` is its float32 length on the backoff ladder, ``retries``
    the retransmits spent on it, ``gave_up`` marks a server that abandoned
    an update (a self-suspect until a later send is acked).  ``ka_age`` is
    the balancer's last-heard clock (data or keepalive), ``age`` the data
    clock; ``drops`` counts losses on the three channels and ``retrans``
    the data retransmits, ``(...)`` each.
    """

    timer: torch.Tensor
    payload: torch.Tensor
    pending: torch.Tensor
    awaiting: torch.Tensor
    backoff: torch.Tensor
    retries: torch.Tensor
    ack_timer: torch.Tensor
    gave_up: torch.Tensor
    ka_timer: torch.Tensor
    ka_since: torch.Tensor
    ka_age: torch.Tensor
    age: torch.Tensor
    drops: torch.Tensor
    retrans: torch.Tensor

    COUNTERS = ("drops", "retrans")

    @staticmethod
    def init(k: int, batch: tuple = (), device=None,
             payload_dtype=torch.int32) -> "AckNetState":
        shape = (*batch, k)

        def full(value, dtype=torch.int32):
            return torch.full(shape, value, dtype=dtype, device=device)

        return AckNetState(
            timer=full(-1),
            payload=full(0, payload_dtype),
            pending=full(False, torch.bool),
            awaiting=full(-1),
            backoff=full(0.0, torch.float32),
            retries=full(0),
            ack_timer=full(-1),
            gave_up=full(False, torch.bool),
            ka_timer=full(-1),
            ka_since=full(0),
            ka_age=full(0),
            age=full(0),
            drops=torch.zeros(batch, dtype=torch.int32, device=device),
            retrans=torch.zeros(batch, dtype=torch.int32, device=device),
        )


def net_step_ack(
    state: AckNetState,
    cfg: NetworkConfig,
    triggered: torch.Tensor,
    payload_now: torch.Tensor,
    drop_u: torch.Tensor,
    jit_u: torch.Tensor,
    ack_u: torch.Tensor,
    can_send: torch.Tensor | None = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, AckNetState]:
    """Advance the reliable (ack'd) wire one slot (the reference's order).

    1. due data, acks and keepalives arrive;
    2. an arriving ack closes its window; a window that expires unacked
       retransmits a *fresh* ``payload_now`` snapshot or, once ``retries``
       reaches ``max_retries``, abandons the update (``gave_up``);
    3. a free server sends on a trigger or piggyback; every send opens a
       window: ``ack_timeout`` for a new send, ``backoff * backoff_base``
       (float32, clamped at 2^30, never a power) for a retransmit;
    4. data rides the wire as in :func:`net_step`;
    5. the balancer acks each delivery on the same wire (billed);
    6. keepalives fire every ``ka_period`` slots (billed); a data or
       keepalive delivery resets ``ka_age``.

    ``ack_u`` is ``(..., 4, K)``: ack drop, ack jitter, keepalive drop,
    keepalive jitter.  A ``False`` in ``can_send`` sends nothing (no send,
    retransmit or keepalive), wipes the pending piggyback, and holds an
    expired window at 0.  Returns as :func:`net_step`; ``sent`` bills data
    sends, acks and keepalives.
    """
    i32, f32 = torch.int32, torch.float32
    in_flight = state.timer >= 0
    due = in_flight & (state.timer == 0)
    ack_arr = (state.ack_timer >= 0) & (state.ack_timer == 0)
    ka_due = (state.ka_timer >= 0) & (state.ka_timer == 0)

    awaiting = state.awaiting >= 0
    expired = awaiting & ~ack_arr & (state.awaiting == 0)
    if can_send is not None:
        expired = expired & can_send
    abandon = expired & (state.retries >= _as(cfg.max_retries, i32, state.retries))
    retrans_now = expired & ~abandon

    free = ~awaiting | ack_arr | abandon
    trig_all = triggered | state.pending
    if can_send is not None:
        trig_all = trig_all & can_send
    send_new = trig_all & free
    send = send_new | retrans_now
    pending = (state.pending | triggered) & ~send
    if can_send is not None:
        pending = pending & can_send

    # Data: a send while an older message still flies supersedes it.
    lost, instant, flying, total_delay = _wire(send, drop_u, jit_u, cfg)
    delivered = due | instant
    out_payload = torch.where(instant, payload_now, state.payload)
    stored = torch.where(flying | instant, payload_now, state.payload)
    timer = torch.where(
        flying, total_delay - 1,
        torch.where(send, -1, torch.where(in_flight & ~due, state.timer - 1, -1)),
    ).to(i32)

    # Acks: one a delivery, with their own draws.
    ack_lost, ack_instant, ack_flying, ack_delay = _wire(
        delivered, ack_u[..., 0, :], ack_u[..., 1, :], cfg)
    ack_timer = torch.where(
        ack_flying, ack_delay - 1,
        torch.where(delivered, -1, torch.where(
            (state.ack_timer >= 0) & ~ack_arr, state.ack_timer - 1, -1)),
    ).to(i32)
    acked = ack_arr | ack_instant

    grown = torch.clamp_max(
        state.backoff * _as(cfg.backoff_base, f32, state.backoff), 2.0**30)
    backoff = torch.where(
        send_new, _as(cfg.ack_timeout, f32, state.backoff),
        torch.where(retrans_now, grown, state.backoff),
    ).to(f32)
    window = torch.clamp_min(backoff.to(i32), 1)
    # A send whose data and ack both arrive this slot completes its round
    # trip at once: no window stays open.
    rt_done = send & instant & ack_instant
    await_t = torch.where(
        send, torch.where(rt_done, -1, window - 1),
        torch.where(
            awaiting & ~acked & ~abandon,
            # An expired window a crashed sender cannot act on holds at 0.
            torch.clamp_min(state.awaiting - 1, 0), -1,
        ),
    ).to(i32)
    retries = torch.where(
        send_new, 0,
        torch.where(retrans_now, state.retries + 1,
                    torch.where(acked, 0, state.retries)),
    ).to(i32)
    gave_up = (state.gave_up | abandon) & ~acked

    ka_p = _as(cfg.ka_period, i32, state.ka_since)
    ka_since = state.ka_since + 1
    ka_fire = (ka_p > 0) & (ka_since >= ka_p)
    if can_send is not None:
        ka_fire = ka_fire & can_send
    ka_lost, ka_instant, ka_flying, ka_delay = _wire(
        ka_fire, ack_u[..., 2, :], ack_u[..., 3, :], cfg)
    ka_deliv = ka_due | ka_instant
    ka_timer = torch.where(
        ka_flying, ka_delay - 1,
        torch.where(ka_fire, -1, torch.where(
            (state.ka_timer >= 0) & ~ka_due, state.ka_timer - 1, -1)),
    ).to(i32)

    sent = (send.sum(-1, dtype=i32) + delivered.sum(-1, dtype=i32)
            + ka_fire.sum(-1, dtype=i32))
    return delivered, out_payload, sent, AckNetState(
        timer=timer,
        payload=stored,
        pending=pending,
        awaiting=await_t,
        backoff=backoff,
        retries=retries,
        ack_timer=ack_timer,
        gave_up=gave_up,
        ka_timer=ka_timer,
        ka_since=torch.where(ka_fire, 0, ka_since).to(i32),
        ka_age=torch.where(delivered | ka_deliv, 0, state.ka_age + 1).to(i32),
        age=torch.where(delivered, 0, state.age + 1).to(i32),
        drops=state.drops + lost.sum(-1, dtype=i32) + ack_lost.sum(-1, dtype=i32)
        + ka_lost.sum(-1, dtype=i32),
        retrans=state.retrans + retrans_now.sum(-1, dtype=i32),
    )


def select_rows(rows: torch.Tensor, new, old):
    """A control-plane state, field by field: ``new`` on the batch rows where
    ``rows`` (bool, the batch shape) holds, ``old`` elsewhere -- how the
    simulators freeze a run past its horizon."""
    def pick(a, b):
        return torch.where(rows.reshape(rows.shape + (1,) * (a.dim() - rows.dim())), a, b)

    return type(new)(**{
        f.name: pick(getattr(new, f.name), getattr(old, f.name))
        for f in dataclasses.fields(new)
    })


def control_plane_init(
    k: int,
    *,
    network: str = "none",
    fault: str = "none",
    transport: str = "fire_forget",
    batch: tuple = (),
    device=None,
    payload_dtype=torch.int32,
):
    """``(comm, net, faulted)``, the initial control-plane carries.

    ``net`` is ``None`` with ``network="none"``, an :class:`AckNetState`
    under ``transport="ack"`` and a :class:`NetState` otherwise; ``faulted``
    (all False, ``(*batch, k)`` bool) is ``None`` with ``fault="none"``.
    """
    comm = CommState.init(k, batch, device)
    if network == "none":
        net = None
    elif transport == "ack":
        net = AckNetState.init(k, batch, device, payload_dtype)
    else:
        net = NetState.init(k, batch, device, payload_dtype)
    faulted = (
        torch.zeros((*batch, k), dtype=torch.bool, device=device)
        if fault != "none" else None
    )
    return comm, net, faulted


def _tree_map(fn, tree, counter: bool = False):
    """Map ``fn(leaf, counter)`` over a tree of the control-plane
    dataclasses, tuples, lists, dicts and ``None``; ``counter`` marks a
    dataclass's running totals (its ``COUNTERS``)."""
    if tree is None:
        return None
    if dataclasses.is_dataclass(tree):
        names = getattr(type(tree), "COUNTERS", ())
        return type(tree)(**{
            f.name: _tree_map(fn, getattr(tree, f.name), f.name in names)
            for f in dataclasses.fields(tree)
        })
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    if isinstance(tree, dict):
        return {name: _tree_map(fn, v) for name, v in tree.items()}
    return fn(tree, counter)


def snapshot_state(tree):
    """A host-side numpy copy of a control-plane (or whole-engine) carry.

    The running totals (``CommState.msgs``, ``NetState.drops``,
    ``AckNetState.drops`` / ``retrans``, of any batch shape) and every
    other 0-d int32 leaf go out as int64, so that host-side sums over many
    segments cannot wrap; :func:`restore_state` narrows them back.
    """

    def cvt(leaf, counter):
        a = leaf.detach().cpu().numpy() if torch.is_tensor(leaf) else np.asarray(leaf)
        a = a.copy()
        if a.dtype == np.int32 and (counter or a.ndim == 0):
            return a.astype(np.int64)
        return a

    return _tree_map(cvt, tree)


def restore_state(tree, device=None):
    """Tensors on ``device`` from a :func:`snapshot_state` tree.

    The int64 totals come back as the int32 the carries hold, saturated at
    the int32 maximum rather than wrapped, so a counter stays monotone.
    """

    def cvt(leaf, counter):
        a = np.asarray(leaf)
        if a.dtype == np.int64 and (counter or a.ndim == 0):
            a = np.minimum(a, _I32_MAX).astype(np.int32)
        return torch.as_tensor(a.copy(), device=device)

    return _tree_map(cvt, tree)


def validate_control_plane(
    *,
    network: str = "none",
    net_delay: float = 0,
    net_jitter: float = 0,
    net_drop: float = 0.0,
    suspect_age: float = 0,
    fault: str = "none",
    crash_rate: float = 0.0,
    recover_rate: float = 0.0,
    slow_factor: float = 1.0,
    transport: str = "fire_forget",
    ack_timeout: float = 0,
    backoff_base: float = 1.0,
    max_retries: float = 0,
    ka_period: float = 0,
    policy: str | None = None,
    comm: str | None = None,
    token_refresh: float | None = None,
) -> None:
    """Reject invalid network, transport, fault and pull operands.

    The reference's checks and messages: each error names the field and
    the fix.  ``policy`` / ``comm`` enforce the 1:1 pairing of a pull
    policy with its token channel, ``token_refresh`` the sign of hsq's
    refresh operand.
    """
    if policy is not None and comm is not None:
        if policy in PULL_KINDS:
            if comm == "exact":
                raise ValueError(
                    f"policy={policy!r} cannot run under comm='exact' --"
                    " the exact full-state channel is push-per-departure"
                    " and would double-bill the token traffic; set"
                    f" comm={policy!r} (the matching pull token channel)"
                )
            if comm != policy:
                raise ValueError(
                    f"policy={policy!r} requires comm={policy!r} (its"
                    f" server-initiated token channel), got comm={comm!r}"
                )
        elif comm in PULL_KINDS:
            raise ValueError(
                f"comm={comm!r} is the token channel of policy={comm!r};"
                f" it cannot drive the push policy {policy!r}"
            )
    if token_refresh is not None and token_refresh < 0:
        raise ValueError(
            f"token_refresh must be >= 0 (the hsq token-refresh rate;"
            f" 0 disables the periodic refresh), got {token_refresh}"
        )
    if network not in ("none", "net"):
        raise ValueError(
            f"unknown network kind: {network!r} (expected 'none' or 'net')"
        )
    if fault not in ("none", "crash", "slow"):
        raise ValueError(
            f"unknown fault kind: {fault!r} "
            "(expected 'none', 'crash' or 'slow')"
        )
    if net_delay < 0:
        raise ValueError(f"net_delay must be >= 0 slots, got {net_delay}")
    if net_jitter < 0:
        raise ValueError(f"net_jitter must be >= 0 slots, got {net_jitter}")
    if net_drop < 0:
        raise ValueError(
            f"net_drop is a probability and must be >= 0, got {net_drop}"
        )
    if net_drop >= 1:
        raise ValueError(
            f"net_drop must be < 1, got {net_drop} -- a drop probability of"
            " 1 loses every message and no trigger retry can ever land"
        )
    if suspect_age < 0:
        raise ValueError(
            f"suspect_age must be >= 0 slots (0 disables suspect masking),"
            f" got {suspect_age}"
        )
    if network == "none":
        for field, val in (
            ("net_delay", net_delay),
            ("net_jitter", net_jitter),
            ("net_drop", net_drop),
        ):
            if val != 0:
                raise ValueError(
                    f"{field}={val} has no effect with network='none';"
                    " set network='net' to model the control plane"
                )
    if transport not in ("fire_forget", "ack"):
        raise ValueError(
            f"unknown transport kind: {transport!r} (expected"
            " 'fire_forget' or 'ack')"
        )
    if transport == "ack":
        if network == "none":
            raise ValueError(
                "transport='ack' needs network='net' -- with"
                " network='none' delivery is instant and lossless, so"
                " there is nothing to acknowledge"
            )
        if ack_timeout < 1:
            raise ValueError(
                f"ack_timeout must be >= 1 slot under transport='ack'"
                f" (a sender must wait at least one slot for its ack;"
                f" 0 would retransmit every slot forever), got"
                f" {ack_timeout}"
            )
        if backoff_base < 1:
            raise ValueError(
                f"backoff_base must be >= 1 (the timeout window may only"
                f" grow across retries), got {backoff_base}"
            )
        if max_retries < 0:
            raise ValueError(
                f"max_retries must be >= 0 (0 abandons after the first"
                f" unacked window), got {max_retries}"
            )
        if ka_period < 0:
            raise ValueError(
                f"ka_period must be >= 0 slots (0 disables keepalives),"
                f" got {ka_period}"
            )
    else:
        for field, val, neutral in (
            ("ack_timeout", ack_timeout, 0),
            ("backoff_base", backoff_base, 1.0),
            ("max_retries", max_retries, 0),
            ("ka_period", ka_period, 0),
        ):
            if val != neutral:
                raise ValueError(
                    f"{field}={val} has no effect with"
                    " transport='fire_forget'; set transport='ack' for"
                    " the reliable transport"
                )
    if not 0.0 <= crash_rate <= 1.0:
        raise ValueError(
            f"crash_rate is a per-slot probability in [0, 1], got {crash_rate}"
        )
    if not 0.0 <= recover_rate <= 1.0:
        raise ValueError(
            f"recover_rate is a per-slot probability in [0, 1],"
            f" got {recover_rate}"
        )
    if crash_rate > 0 and recover_rate == 0:
        raise ValueError(
            "recover_rate must be > 0 when crash_rate > 0 -- with"
            f" recover_rate=0 every crashed server (crash_rate={crash_rate})"
            " stays down forever and the system drains to zero capacity"
        )
    if slow_factor <= 0 or slow_factor > 1:
        raise ValueError(
            f"slow_factor scales service_rates and must be in (0, 1],"
            f" got {slow_factor}"
        )
    if fault == "none":
        for field, val, neutral in (
            ("crash_rate", crash_rate, 0.0),
            ("recover_rate", recover_rate, 0.0),
            ("slow_factor", slow_factor, 1.0),
        ):
            if val != neutral:
                raise ValueError(
                    f"{field}={val} has no effect with fault='none';"
                    " set fault='crash' or fault='slow'"
                )
    if fault == "crash" and slow_factor != 1.0:
        raise ValueError(
            f"slow_factor={slow_factor} has no effect with fault='crash';"
            " use fault='slow' for transient slowdowns"
        )
    if suspect_age > 0 and network == "none" and fault == "none":
        raise ValueError(
            "suspect_age > 0 needs a modeled control plane -- with"
            " network='none' and fault='none' updates are instant and"
            " servers never fail, so the staleness timeout would only"
            " mis-mask idle servers; enable network='net' and/or a fault"
            " kind"
        )
