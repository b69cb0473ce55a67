"""Multi-dispatcher MoE dispatch simulation: CARE at the expert tier.

Port of ``repro/core/dispatch_sim.py``.  The training-tier balancer
(:mod:`repro_torch.core.moe_balancer`) is exact when a single dispatcher
routes every token (Remark 4.6: it knows all arrivals, so no message is
needed).  The communication question arises with *several* dispatchers --
the [VKO20] setting the paper targets -- where each router sees only its
own arrivals and the exact per-expert state lives with the experts.

* ``E`` experts are the servers.  Each serves ``mu`` tokens a step from a
  FIFO backlog ``q_e``: ``q_e(t+1) = max(q_e + a_e - mu, 0)``, the slotted
  Lindley recursion whose idleness reflection makes departures hard to
  emulate (Section 6 of the paper).
* ``D`` dispatchers each route ``T`` tokens a step, top-k over gate scores
  drawn from a dispatcher-specific, drifting preference plus a persistent
  global skew.
* Between messages each dispatcher emulates the queues (Def 4.4): its own
  arrivals exactly (Eq. 10), the other ``D-1`` at its own rate (MSR on
  arrivals), departures at ``mu`` (MSR), with the same reflection.
* Messages carry the exact queue state; the trigger and the message count
  come from the shared core :mod:`repro_torch.core.care.comm`
  (:meth:`DispatchSimConfig.comm_config`): ``exact`` syncs every dispatcher
  every step, ``dt-x`` every x steps, ``et-x`` messages only the dispatcher
  whose largest queue error reached ``x * mu`` tokens, ``off`` never.
* Routing bias: JSAQ on the approximated queue, ``alpha *
  clip(rel(q_approx))`` plus an integral term that cancels the skew.

The step takes its random draws as tensors (:func:`run_draws`): ``base``
``(B, E)`` and, per step, the preference walk ``(B, D, E)`` and the logit
noise ``(B, D, T, E)``, standard normals that the step scales by
``base_skew``, ``drift`` and ``noise``.  :func:`simulate` and
:func:`dispatch_batch` draw them step by step from a ``torch.Generator``
a seed on the run's device, so device memory stays O(B D T E).

Float32 arithmetic follows the reference as XLA compiles it on the CPU
(at E = 16; at E = 64 XLA sums its means in another order): every mean
over the experts is a sequential sum in expert order divided by ``E``; the multiply-adds of the preference walk, the selection bias and the
``gamma`` step are fused (one rounding: the exact product and the sum in
float64, then float32); the error is scaled by the float32 ``1 / mu``.
These are elementwise or sequential operations, so the CPU and the card
give the same bits.  The top-k takes ties at the k-th value in index
order, as ``lax.top_k`` does (:func:`_top_k_mask`); the counts depend only
on the chosen set.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np
import torch

from repro_torch.core.care import comm as comm_lib
from repro_torch.core.care.slotted_sim import _resolve_device

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class DispatchSimConfig:
    experts: int = 64
    dispatchers: int = 8
    tokens_per_step: int = 256  # per dispatcher
    top_k: int = 8
    steps: int = 400
    load: float = 0.92  # utilisation: arrivals / total service capacity
    comm: str = "et"  # "exact" | "dt" | "et" | "off"
    x: int = 2  # dt period / et error threshold (units of mu tokens)
    # Traffic model.
    base_skew: float = 1.0  # persistent global expert preference (std)
    drift: float = 0.10  # per-step random-walk std of dispatcher prefs
    noise: float = 1.0  # per-token logit noise std
    # Controller (mirrors CareConfig).
    bias_alpha: float = 0.6
    bias_clip: float = 2.0
    gamma: float = 0.02
    enabled: bool = True

    @property
    def mu(self) -> float:
        """Per-expert service capacity (tokens/step)."""
        arrivals = self.dispatchers * self.tokens_per_step * self.top_k
        return arrivals / (self.load * self.experts)

    def comm_config(self) -> comm_lib.CommConfig:
        """This tier's comm names in shared-core terms: ``exact`` is RT with
        period 1, ``dt`` RT with period x (the paper's time-synchronised
        variant), ``et`` ET-x with the error in units of ``mu`` tokens,
        ``off`` never triggers."""
        if self.comm == "exact":
            return comm_lib.CommConfig(kind="rt", rt_period=1)
        if self.comm == "dt":
            return comm_lib.CommConfig(kind="rt", rt_period=self.x)
        if self.comm == "et":
            return comm_lib.CommConfig(kind="et", x=self.x)
        if self.comm == "off":
            return comm_lib.CommConfig(kind="none")
        raise ValueError(f"unknown comm mode: {self.comm}")


@dataclasses.dataclass
class DispatchSimResult:
    backlog: np.ndarray  # (steps,) mean per-expert queue
    gap: np.ndarray  # (steps,) max_e q - min_e q (SSC metric)
    messages: int
    msgs_per_step: float
    rel_comm: float  # msgs / (D * steps): fraction of the exact baseline
    tail_backlog: float  # mean over the 2nd half (steady state)
    tail_gap: float
    transient_gap: float  # mean over steps [50, steps/2): convergence cost
    max_err: float  # sup over (step, dispatcher) of |q - q_approx| / mu


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(np.float32(value), device=like.device)


def _mean(x: torch.Tensor) -> torch.Tensor:
    """Mean over the last axis as a sequential float32 sum in index order,
    divided by its length (keepdims)."""
    acc = x[..., 0]
    for i in range(1, x.shape[-1]):
        acc = acc + x[..., i]
    return (acc / x.shape[-1])[..., None]


def _fma(a: torch.Tensor, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * x + c`` with one rounding to float32."""
    return (a.double() * x.double() + c.double()).to(_F32)


def _top_k_mask(score: torch.Tensor, k: int) -> torch.Tensor:
    """The ``k`` largest entries of each row of ``score`` as a bool mask,
    ties at the k-th value going to the lowest indices (``lax.top_k``'s
    set).  Only the k-th largest value is taken from ``torch.topk``, whose
    order among ties is unspecified: every entry above it is in, and the
    entries equal to it fill the remaining places in index order."""
    kth = torch.topk(score, k, dim=-1).values[..., k - 1 :]
    above = score > kth
    tied = score == kth
    room = k - above.sum(-1, keepdim=True, dtype=torch.int32)
    return above | (tied & (tied.cumsum(-1, dtype=torch.int32) <= room))


def _rel(load: torch.Tensor, mean: torch.Tensor) -> torch.Tensor:
    """``load / (mean + 1e-6) - 1``; ``mean`` is ``_mean(load)``."""
    return load / (mean + 1e-6) - 1.0


def run_draws(
    base: torch.Tensor,
    draws: Iterable[tuple[torch.Tensor, torch.Tensor]],
    cfg: DispatchSimConfig,
) -> dict:
    """Run ``cfg.steps`` steps for ``B`` runs on given standard normals.

    Args:
      base: ``(B, E)`` float32, the persistent skew's normals.
      draws: yields, per step, the preference walk ``(B, D, E)`` and the
        logit noise ``(B, D, T, E)`` float32 normals, on ``base``'s device.
      cfg: the regime.

    Returns per-run tensors: ``backlog``, ``gap`` and ``err`` (the largest
    dispatcher error over ``mu``) ``(B, steps)`` float32, ``msgs`` ``(B,)``
    int32, and ``counts`` ``(B, steps, D, E)`` float32, each dispatcher's
    routed tokens per expert and step.
    """
    b_n = base.shape[0]
    d, e, t, k = cfg.dispatchers, cfg.experts, cfg.tokens_per_step, cfg.top_k
    dev = base.device
    ccfg = cfg.comm_config()
    mu = _f32(cfg.mu, base)
    inv_mu = 1.0 / mu
    drift, noise = _f32(cfg.drift, base), _f32(cfg.noise, base)
    alpha, gamma = _f32(cfg.bias_alpha, base), _f32(cfg.gamma, base)
    skew = _f32(cfg.base_skew, base) * base  # (B, E)

    pref = torch.zeros((b_n, d, e), dtype=_F32, device=dev)
    q_true = torch.zeros((b_n, e), dtype=_F32, device=dev)
    q_app = torch.zeros_like(pref)
    # The mean of each q_app row, carried from step to step: a row snapped
    # to q_true takes q_true's mean (the same sum of the same values).
    app_mean = torch.zeros((b_n, d, 1), dtype=_F32, device=dev)
    bias = torch.zeros_like(pref)
    comm_state = comm_lib.CommState.init(d, batch=(b_n,), device=dev)
    no_deps = torch.zeros((b_n, d), dtype=torch.int32, device=dev)
    backlog = torch.zeros((b_n, cfg.steps), dtype=_F32, device=dev)
    gap = torch.zeros_like(backlog)
    errs = torch.zeros_like(backlog)
    counts_trace = torch.zeros((b_n, cfg.steps, d, e), dtype=_F32, device=dev)

    steps = 0
    for s, (walk, noise_n) in enumerate(draws):
        if s == cfg.steps:
            break
        steps += 1
        pref = _fma(drift, walk, pref)
        logits = (skew[:, None, None, :] + pref[:, :, None, :]) + noise * noise_n
        # JSAQ bias on the *approximated* queue (PI controller).
        if cfg.enabled:
            sel_bias = _fma(
                alpha, torch.clamp(_rel(q_app, app_mean), -cfg.bias_clip, cfg.bias_clip),
                bias)
        else:
            sel_bias = torch.zeros_like(bias)
        score = logits - sel_bias[:, :, None, :]
        counts = _top_k_mask(score, k).sum(2, dtype=_F32)  # (B, D, E)
        counts_trace[:, s] = counts

        # True expert queues: Lindley recursion with service capacity mu.
        q_true = torch.clamp_min(q_true + counts.sum(1) - mu, 0.0)
        # Dispatcher emulation: own arrivals exact, the others at the same
        # rate, service at mu, the same reflection.
        q_app = torch.clamp_min(q_app + d * counts - mu, 0.0)
        # Every row's mean and q_true's in one sequential sum.
        means = _mean(torch.cat([q_app, q_true[:, None, :]], 1))  # (B, D + 1, 1)
        app_mean, true_mean = means[:, :d], means[:, d:]

        bias = _fma(gamma, torch.clamp(_rel(q_app, app_mean), -1.0, 1.0), bias)
        bias = bias - _mean(bias)

        err = (q_app - q_true[:, None, :]).abs().amax(-1) * inv_mu  # (B, D)
        trigger, comm_state = comm_lib.evaluate(comm_state, ccfg, err, no_deps)
        q_app = torch.where(trigger[..., None], q_true[:, None, :], q_app)
        app_mean = torch.where(trigger[..., None], true_mean, app_mean)

        backlog[:, s] = true_mean[:, 0, 0]
        gap[:, s] = q_true.amax(-1) - q_true.amin(-1)
        errs[:, s] = err.amax(-1)
    if steps != cfg.steps:
        raise ValueError(f"the draws cover {steps} steps, the config {cfg.steps}")
    return {"backlog": backlog, "gap": gap, "err": errs, "msgs": comm_state.msgs,
            "counts": counts_trace}


def _finalize(backlog, gap, errs, msgs, cfg: DispatchSimConfig) -> DispatchSimResult:
    backlog, gap = np.asarray(backlog), np.asarray(gap)
    half = len(backlog) // 2
    return DispatchSimResult(
        backlog=backlog,
        gap=gap,
        messages=int(msgs),
        msgs_per_step=float(msgs) / cfg.steps,
        rel_comm=float(msgs) / (cfg.dispatchers * cfg.steps),
        tail_backlog=float(backlog[half:].mean()),
        tail_gap=float(gap[half:].mean()),
        transient_gap=float(gap[50:half].mean()) if half > 50 else float("nan"),
        max_err=float(np.asarray(errs).max()),
    )


def sample_draws(seeds: Sequence[int], cfg: DispatchSimConfig, device):
    """The port's own draws: a ``torch.Generator`` a seed on ``device``.

    Returns ``(base (B, E), draws)``; ``draws`` yields each step's walk and
    noise, drawn only when the step asks for them.  Each seed's stream is
    its own (``base``, then per step the walk and the noise), so a seed
    draws the same numbers alone or in a batch.
    """
    d, e, t = cfg.dispatchers, cfg.experts, cfg.tokens_per_step
    gens = []
    for s in seeds:
        g = torch.Generator(device=device)
        g.manual_seed(int(s))
        gens.append(g)

    def normal(g, shape):
        return torch.randn(shape, generator=g, dtype=_F32, device=device)

    base = torch.stack([normal(g, (e,)) for g in gens])

    def draws():
        for _ in range(cfg.steps):
            walk, noise = [], []
            for g in gens:
                walk.append(normal(g, (d, e)))
                noise.append(normal(g, (d, t, e)))
            yield torch.stack(walk), torch.stack(noise)

    return base, draws()


def results(raw: dict, cfg: DispatchSimConfig) -> list[DispatchSimResult]:
    """Per-run :class:`DispatchSimResult` list from :func:`run_draws`."""
    host = {name: raw[name].cpu().numpy() for name in ("backlog", "gap", "err", "msgs")}
    return [
        _finalize(host["backlog"][i], host["gap"][i], host["err"][i], host["msgs"][i], cfg)
        for i in range(host["msgs"].shape[0])
    ]


def dispatch_batch(seeds, cfg: DispatchSimConfig, *, device=None) -> list[DispatchSimResult]:
    """Run a seed sweep as one leading run axis (one result per seed).

    The counterpart of the reference's vmapped scan: every seed advances in
    one loop over steps, and each equals :func:`simulate` of that seed.
    ``device=None`` means the CUDA card; pass ``device="cpu"`` for the CPU.
    """
    dev = _resolve_device(device)
    base, draws = sample_draws(list(seeds), cfg, dev)
    return results(run_draws(base, draws, cfg), cfg)


def simulate(seed: int, cfg: DispatchSimConfig, *, device=None) -> DispatchSimResult:
    """One run of one regime and one seed."""
    return dispatch_batch([seed], cfg, device=device)[0]
