"""Batched LM serving: prefill and incremental decode over the KV/SSM cache."""
from .engine import ServeEngine

__all__ = ["ServeEngine"]
