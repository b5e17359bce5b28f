"""PyTorch/CUDA port of the TA-MoE system for NVIDIA Hopper (H100).

The JAX package ``repro`` is the reference this package is held against;
module paths mirror it (``repro_torch.core.dispatch.engine`` is the
counterpart of ``repro.core.dispatch.engine``).  This package imports
``torch`` and never ``jax`` or anything of ``repro``.

Every Pallas kernel on a ported path has a hand-written CUDA kernel under
``csrc/`` (built with nvcc for ``sm_90a`` at first use, see
``kernels/backend.py``) and a plain PyTorch version beside it in its
``ref.py``.  Entry points run on ``"cuda"`` unless the caller passes
``device="cpu"``; on CPU tensors every kernel wrapper takes its plain
version.
"""
