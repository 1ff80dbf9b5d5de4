"""PyTorch/CUDA port of zenker_audio_detection_tpu.

Two-stage AST swallow-sound classification (Zenker's diverticulum
detection) on an NVIDIA GPU. The module layout mirrors the JAX package's;
this package imports neither JAX nor anything of the JAX package.
"""
