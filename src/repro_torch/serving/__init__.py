"""Serving: the LM families' caches, prefill/decode steps and greedy engine,
and the request-level serving simulator (traffic through a continuous-batching
scheduler with robustness policies, priced by the memory system)."""
from .engine import ServeConfig, ServingEngine, build_prefill, build_serve_step, init_cache
from .scheduler import (
    DEGRADE_MODES,
    ReplayOracle,
    RobustnessPolicy,
    ServingScenario,
    simulate_serving,
)

__all__ = [
    "ServeConfig",
    "ServingEngine",
    "build_prefill",
    "build_serve_step",
    "init_cache",
    "DEGRADE_MODES",
    "ReplayOracle",
    "RobustnessPolicy",
    "ServingScenario",
    "simulate_serving",
]
