"""PyTorch + CUDA port of the repro serving path (H100 / sm_90a).

Imports torch and numpy only; nothing of JAX or of the ``repro`` package.
"""
