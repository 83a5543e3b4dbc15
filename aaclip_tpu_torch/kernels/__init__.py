"""Hand-written CUDA kernels (sources in csrc/, built by build.py)."""
