"""CARE: Communication, Approximation, Resource allocation, dynamic Environment.

The port of ``repro.core.care`` (Mendelson & Xu, "Load Balancing Using
Sparse Communication"):

comm        -- push trigger core (RT / DT / ET / ET+RT / exact / none)
approx      -- basic / MSR / MSR-x queue emulation
routing     -- JSQ / JSAQ / round robin
workload    -- Bernoulli arrivals and geometric / deterministic sizes as
               functions of uniforms, plus torch.Generator samplers
slotted_sim -- the slotted simulator of Section 9 (dense and fused backends)
metrics     -- JCT and communication metrics
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
