"""The plain reference the benchmark judges the program by.

Plain PyTorch and NumPy only: nothing here imports the program, JAX or the
JAX package. It is given the inputs the benchmark generated (rows, texts,
prices, queries) and works out everything else itself.
"""
