"""PyTorch port of the MXNET-MPI reproduction (``src/repro`` is the JAX
reference it is held against).

Slice 1: mpi-SGD in one process. The production train step packs the
gradient pytree into the f32 FlatBuffer, runs ONE hand-written fused
optimizer kernel (momentum SGD, AdamW or AdaGrad) over it, and unpacks the
updated params. Module names mirror ``repro`` so every counterpart is easy
to find. The package imports ``torch`` and never ``jax`` or ``repro``.
"""
