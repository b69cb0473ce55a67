"""Serving tier of the port: continuous batching with a CARE request dispatcher."""

from repro_torch.serve.engine import (  # noqa: F401
    EngineScenario,
    EngineStatic,
    ServeConfig,
    ServeResult,
    ServeWorkload,
    sample_workload,
    serve_grid,
    serve_one,
    workload_for,
)
