"""The LM architecture family: configs (:mod:`.config`), transformer and
SSD layers (:mod:`.layers`, :mod:`.ssm`), the stacked-pattern
:class:`~.model.TransformerLM`, and the installer of the JAX package's
parameter tree (:mod:`.convert`)."""
