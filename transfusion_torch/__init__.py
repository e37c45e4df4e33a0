"""PyTorch/CUDA port of the TransFusion Ego4D short-term object-interaction
model, held against the JAX package ``transfusion_tpu`` as its reference.

The eval path (backbone, narration encoder, per-level fusion, FPN, RPN, RoI
heads and the static-shape postprocess) is plain PyTorch around three
hand-written Hopper kernels (``csrc/``): (residual-add +) LayerNorm, attention
forward and multiscale RoIAlign forward. See ``kernels.py`` for how they are
built and bound.
"""
