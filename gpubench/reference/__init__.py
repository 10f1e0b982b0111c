"""The plain reference of the benchmark's output check: NumPy, SciPy and
plain PyTorch, importing nothing of the program."""
