"""Serving: batched prefill + greedy decode of the language-model stack
(:class:`ServeEngine`), and the estimation services -- queued, batched MAP
solves of whole records (:class:`TrajectoryEngine`) and online fixed-lag
smoothing of streaming tracks (:class:`StreamingEngine`)."""
from .engine import Request, ServeEngine
from .streaming import StreamingEngine
from .trajectory import TrajectoryEngine

__all__ = ["Request", "ServeEngine", "StreamingEngine", "TrajectoryEngine"]
