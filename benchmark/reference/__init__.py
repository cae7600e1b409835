"""Plain PyTorch / NumPy references of what the benchmark's cells time.

Nothing here imports the program (``diffusion_extensions_tpu_torch``), JAX
or the JAX package: the models, processes, tables and the optimizer are
written out again from their published description, so that a cell's
``correct`` compares the program with an independent computation.
"""
