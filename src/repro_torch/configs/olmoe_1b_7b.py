"""olmoe-1b-7b — 64 experts top-8 [arXiv:2409.02060; hf]."""
import torch

from repro_torch.nn.transformer import ArchConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b", family="moe", n_layers=16, d_model=2048,
    n_heads=16, n_kv=16, d_ff=1024, vocab=50_304,
    moe_experts=64, moe_top_k=8, head_dim=128, seq_shard=True,
    param_dtype=torch.bfloat16,
    notes="64e top-8 MoE (d_ff=1024 per expert); EP over model axis",
)
