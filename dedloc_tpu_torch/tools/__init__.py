"""The port's tools: the counterparts of the repository's scripts that drive the JAX package."""
