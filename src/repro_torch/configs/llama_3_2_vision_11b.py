"""llama-3.2-vision-11b — cross-attn image layers [hf:meta-llama; unverified]."""
import torch

from repro_torch.nn.transformer import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-11b", family="vlm", n_layers=40, d_model=4096,
    n_heads=32, n_kv=8, d_ff=14336, vocab=128_256,
    cross_every=5, n_memory=1600, head_dim=128, seq_shard=True,
    param_dtype=torch.bfloat16,
    notes=("text decoder w/ cross-attention every 5th layer; vision frontend "
           "is a stub — input_specs() provides 1600 patch embeddings; full "
           "attention -> long_500k skipped"),
)
