"""minitron-4b — pruned nemotron [arXiv:2407.14679; hf]."""
import torch

from repro_torch.nn.transformer import ArchConfig

CONFIG = ArchConfig(
    name="minitron-4b", family="dense", n_layers=32, d_model=3072,
    n_heads=24, n_kv=8, d_ff=9216, vocab=256_000,
    ffn_gated=False,                      # squared-ReLU MLP (nemotron)
    head_dim=128, seq_shard=True, param_dtype=torch.bfloat16,
    notes="pruned nemotron; full attention -> long_500k skipped",
)
