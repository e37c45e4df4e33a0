"""PyTorch/CUDA port of the TransFusion Ego4D short-term object-interaction
model, held against the JAX package ``transfusion_tpu`` as its reference.

The eval path (backbone, narration encoder, per-level fusion, FPN, RPN, RoI
heads and the static-shape postprocess), the train step (target assignment
and sampling, losses, the optimizers, trainable BatchNorm, ``train/``), data
parallelism over ranks (``parallel/``) and the trainer with its CLI
(``config/``, ``data/``, ``metrics/``, ``runner/``) are plain PyTorch
and numpy around hand-written Hopper kernels (``csrc/``): (residual-add
+) LayerNorm, attention forward with probability dropout, attention backward
(dQ; dK, dV), and multiscale RoIAlign forward and backward. See
``kernels.py`` for how they are built and bound.
"""
