"""PyTorch/CUDA port of the SGD study engine (``repro`` is the JAX reference).

``core`` holds the GLM losses and gradients, the ELL sparse layout and the
SyncSGD / AsyncLocalSGD engine; ``kernels`` the hand-written Hopper kernels
(``kernels/csrc``) behind a per-family registry; ``data`` the synthetic
generators; ``serve``, ``live`` the scoring service and train-while-serving;
``configs``, ``nn``, ``serve.engine`` and ``launch.serve`` LM serving for
the dense family; ``convert`` carries state and parameters across from the
reference.  What
makes tensors (``data``, the ELL builders, ``convert``) puts them on
``cuda`` unless the caller passes ``device="cpu"``; the engine and the
kernels run where their tensors are.
"""
