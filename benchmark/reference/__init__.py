"""The benchmark's plain reference: what the program under test must give,
worked out again from the design, the workload and the seed in plain NumPy
and PyTorch.  It imports nothing of the program and nothing of JAX."""
