"""PyTorch/CUDA port of `adaface_tpu` for one NVIDIA H100.

A second package beside the JAX one, which stays the reference. It imports
torch and numpy, never jax or `adaface_tpu`. Entry points run on the card
(`device="cuda"`, the default) and raise when none is present unless the
caller passes `device="cpu"`. See README.md ("PyTorch/H100 port").
"""
