"""Plain PyTorch references that the benchmark holds the program to."""
