"""PyTorch/CUDA port of the CushionCache serving path (the JAX package
``repro`` stays the reference). Imports torch, never jax."""
