"""Serving: the continuous-batching engine on stripe_jit + the wave baseline."""
from .engine import ServingEngine
from .request import EngineConfig, Request, SamplingParams
from .wave import WaveEngine

__all__ = ["ServingEngine", "WaveEngine", "Request", "SamplingParams",
           "EngineConfig"]
