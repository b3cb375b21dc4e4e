"""Launchers: the serve launcher (``python -m repro_torch.launch.serve``),
its warm-set cache directory and its tuned process environment."""
