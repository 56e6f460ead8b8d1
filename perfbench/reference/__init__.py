"""The plain reference the benchmark holds the program to: the env steps
of both families, the kernels' random numbers and the policy, in plain
PyTorch, importing nothing of the program."""
