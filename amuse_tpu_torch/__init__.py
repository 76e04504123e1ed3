"""PyTorch/CUDA port of amuse-tpu for NVIDIA Hopper GPUs.

A second package beside ``amuse_tpu`` (the JAX reference). It imports
``torch`` and never ``jax``, and no module of ``amuse_tpu``. Module names
mirror the JAX package so each port has an obvious counterpart; the TPU
kernels on the ported paths (``infer_gesture``, ``edit_gesture``,
``prepare_data``, ``train_audio``, ``train_gesture``, ``eval_gesture``) are
hand-written CUDA C++ for ``sm_90a`` under ``csrc/`` (see ``ops/``).

Entry points take ``device="cuda"`` by default and raise when CUDA is
absent; tests pass ``device="cpu"``, where each kernel wrapper runs its
plain PyTorch version.
"""
