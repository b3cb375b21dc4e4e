"""The LM trainer: AdamW with the reference's numerics (``optimizer.py``),
the eager train step and loop (``loop.py``) and flat-npz checkpoints in
the reference's format (``checkpoint.py``)."""
