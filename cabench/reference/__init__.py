"""The plain reference the benchmark holds the program against.  It imports
neither the program nor JAX."""
