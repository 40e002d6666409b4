"""command-r-35b — GQA, no-bias [hf:CohereForAI/c4ai-command-r-v01; unverified]."""
import torch

from repro_torch.nn.transformer import ArchConfig

CONFIG = ArchConfig(
    name="command-r-35b", family="dense", n_layers=40, d_model=8192,
    n_heads=64, n_kv=8, d_ff=22528, vocab=256_000,
    ffn_gated=True, head_dim=128, fsdp=True, seq_shard=True,
    param_dtype=torch.bfloat16,
    notes="35B dense; FSDP over data axis; full attention -> long_500k skipped",
)
