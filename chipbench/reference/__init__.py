"""The plain reference that decides ``correct``: PyTorch and NumPy only.
It imports neither JAX nor the JAX package nor anything of the port, and
works out from the benchmark's inputs (the configuration file, the
parameters drawn from the seed, the traffic) whatever it compares."""
