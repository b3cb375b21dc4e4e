"""Serving. So far only the wave-by-wave engine over the LM architectures
(:mod:`.lm_wave`); the continuous-batching subsystem is not ported yet, so
nothing here imports an ``engine`` module."""
