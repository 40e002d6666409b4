"""kimi-k2-1t-a32b — trillion-param MoE (paper-table) [arXiv:2501.kimi2]."""
import torch

from repro_torch.nn.transformer import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b", family="moe", n_layers=61, d_model=7168,
    n_heads=64, n_kv=8, d_ff=2048, vocab=163_840,
    moe_experts=384, moe_top_k=8, head_dim=112, fsdp=True, seq_shard=True,
    param_dtype=torch.bfloat16,
    notes=("~1T total / 32B active; experts sharded EP x FSDP; needs >=512 "
           "chips for training memory (recorded in EXPERIMENTS.md)"),
)
