"""Serving: batched prefill + greedy decode of the language-model stack."""
from .engine import Request, ServeEngine

__all__ = ["Request", "ServeEngine"]
