"""h2o-danube-1.8b — llama+mistral mix, SWA [arXiv:2401.16818; hf]."""
import torch

from repro_torch.nn.transformer import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-1.8b", family="dense", n_layers=24, d_model=2560,
    n_heads=32, n_kv=8, d_ff=6912, vocab=32_000,
    ffn_gated=True, window=4096, head_dim=80, seq_shard=True,
    param_dtype=torch.bfloat16,
    notes="sliding-window attention (4096) -> sub-quadratic; runs long_500k",
)
