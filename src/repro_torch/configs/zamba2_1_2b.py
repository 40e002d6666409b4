"""zamba2-1.2b — Mamba2 + shared attn blocks [arXiv:2411.15242; hf]."""
import torch

from repro_torch.nn.transformer import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b", family="hybrid", n_layers=38, d_model=2048,
    n_heads=32, n_kv=32, d_ff=8192, vocab=32_000, ssm_state=64,
    head_dim=64, seq_shard=True, param_dtype=torch.bfloat16,
    notes=("Mamba2 backbone, one weight-tied attention block applied per 6 "
           "mamba layers; runs long_500k (O(1) SSM state; shared attention "
           "ring-cached at 4096 in long-context mode)"),
)
