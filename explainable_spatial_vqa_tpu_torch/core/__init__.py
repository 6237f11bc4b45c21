"""Framework-free core pieces, copied from the JAX package."""
