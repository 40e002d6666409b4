"""minitron-8b — pruned nemotron [arXiv:2407.14679; hf]."""
import torch

from repro_torch.nn.transformer import ArchConfig

CONFIG = ArchConfig(
    name="minitron-8b", family="dense", n_layers=32, d_model=4096,
    n_heads=32, n_kv=8, d_ff=16384, vocab=256_000,
    ffn_gated=False, head_dim=128, seq_shard=True, param_dtype=torch.bfloat16,
    notes="pruned nemotron; full attention -> long_500k skipped",
)
