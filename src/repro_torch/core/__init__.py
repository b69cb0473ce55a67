"""Core library of the port: the CARE protocol and its slotted simulator."""

from repro_torch.core.care import (  # noqa: F401
    Scenario,
    ServiceProcess,
    SimConfig,
    SimResult,
    StaticConfig,
    approx,
    comm,
    metrics,
    routing,
    simulate,
    simulate_batch,
    simulate_grid,
    theory,
    workload,
)
