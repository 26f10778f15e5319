"""Serving of the LM families: caches, prefill/decode steps, greedy engine."""
from .engine import ServeConfig, ServingEngine, build_prefill, build_serve_step, init_cache

__all__ = ["ServeConfig", "ServingEngine", "build_prefill", "build_serve_step", "init_cache"]
