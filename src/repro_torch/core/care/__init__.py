"""CARE: Communication, Approximation, Resource allocation, dynamic Environment.

The port of ``repro.core.care`` (Mendelson & Xu, "Load Balancing Using
Sparse Communication"):

comm        -- trigger core (RT / DT / ET / ET+RT / exact / none, and the
               pull kinds JIQ / hsq)
approx      -- basic / MSR / MSR-x queue emulation
routing     -- JSQ / JSAQ / SQ(d) / round robin / random / JIQ / hsq
workload    -- Bernoulli and MMPP arrivals (optionally diurnal), geometric /
               deterministic / Pareto / Weibull sizes and arrival classes
               as functions of uniforms, plus torch.Generator samplers
slotted_sim -- the slotted simulator of Section 9 (dense and fused backends)
metrics     -- JCT, communication and token-pool metrics
theory      -- closed-form bounds of Theorems 2.3-2.5
"""

from repro_torch.core.care.slotted_sim import (  # noqa: F401
    Scenario,
    SimConfig,
    SimResult,
    StaticConfig,
    simulate,
    simulate_batch,
    simulate_grid,
)
from repro_torch.core.care.workload import ServiceProcess  # noqa: F401
from repro_torch.core.care import (  # noqa: F401
    approx,
    comm,
    metrics,
    routing,
    theory,
    workload,
)
