"""Training data: the synthetic token pipeline (``pipeline.py``, a copy of
the reference's framework-free module)."""
