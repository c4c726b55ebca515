"""Serving: the batched speculative engine (``serving.engine``)."""
