"""Serving substrate of the port (the serving half of ``repro.train``:
batched prefill, single-token decode and greedy generation)."""
from .serve_step import greedy_generate, make_prefill_step, make_serve_step

__all__ = ["greedy_generate", "make_prefill_step", "make_serve_step"]
