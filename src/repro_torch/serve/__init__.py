"""Serving: prefill + greedy decode over a static batch."""

from .engine import ServeEngine, make_prefill, make_serve_step

__all__ = ["ServeEngine", "make_prefill", "make_serve_step"]
