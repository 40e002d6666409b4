from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    save_checkpoint, load_checkpoint, latest_step, CheckpointManager)
