"""Core SGD engine: GLM objectives, ELL sparse layout, SyncSGD / AsyncLocalSGD."""
