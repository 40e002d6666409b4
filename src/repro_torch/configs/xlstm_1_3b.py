"""xlstm-1.3b — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified]."""
import torch

from repro_torch.nn.transformer import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b", family="ssm", n_layers=48, d_model=2048,
    n_heads=4, n_kv=4, d_ff=0, vocab=50_304,
    seq_shard=False,  # hillclimb-2: chunk math is S-axis-local; SP resharding cost it X~2x
    param_dtype=torch.bfloat16,
    ssm_chunk=512,  # hillclimb-2: halves per-chunk state saves vs 256,
    notes=("superblocks of 7 mLSTM + 1 sLSTM; d_ff=0 — up/down projections "
           "live inside the blocks; chunked-parallel train, recurrent "
           "decode; runs long_500k"),
)
