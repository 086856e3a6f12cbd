"""Framework-free utilities copied from the JAX package."""
