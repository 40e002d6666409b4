"""musicgen-large — decoder-only over EnCodec tokens [arXiv:2306.05284; hf]."""
import torch

from repro_torch.nn.transformer import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large", family="audio", n_layers=48, d_model=2048,
    n_heads=32, n_kv=32, d_ff=8192, vocab=2048,
    ffn_gated=True, head_dim=64, seq_shard=True, param_dtype=torch.bfloat16,
    notes=("backbone only: EnCodec frontend is a stub — input_specs() "
           "provides precomputed frame embeddings [B,S,d]; head over the "
           "2048-entry codec vocab; full attention -> long_500k skipped"),
)
