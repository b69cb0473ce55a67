"""Serving tier of the port: continuous batching with a CARE request dispatcher."""

from repro_torch.serve.engine import (  # noqa: F401
    CareDispatcher,
    EngineConfig,
    EngineScenario,
    EngineStatic,
    Request,
    ServeConfig,
    ServeResult,
    ServeWorkload,
    pick_min_tied,
    run_serving_sim,
    sample_workload,
    serve_grid,
    serve_one,
    workload_for,
)
