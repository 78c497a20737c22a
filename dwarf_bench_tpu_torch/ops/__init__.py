"""Operators. ``*_cuda.py`` modules wrap the CUDA kernels of ``csrc/`` (each
beside its plain PyTorch twin); the others are the ports of the JAX
package's operator modules of the same names."""
