"""Serving: the continuous-batching engine on stripe_jit."""
from .engine import ServingEngine
from .request import EngineConfig, Request, SamplingParams

__all__ = ["ServingEngine", "Request", "SamplingParams", "EngineConfig"]
