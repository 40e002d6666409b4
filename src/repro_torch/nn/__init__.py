"""The LM substrate: dense-family transformer, attention on the
``flash_attn`` kernel, and the single-token decode path."""
