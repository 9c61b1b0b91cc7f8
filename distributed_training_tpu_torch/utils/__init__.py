"""Framework-free helpers copied from the JAX package."""
