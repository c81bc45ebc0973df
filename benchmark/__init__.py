"""The benchmark of the PyTorch and CUDA port (``poismf_torch``): one
command runs one cell once (``benchmark/run.py``).  It imports neither
JAX nor the JAX package."""
