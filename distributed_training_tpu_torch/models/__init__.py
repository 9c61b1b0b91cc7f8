"""Models: the decoder-only transformer and the JAX weight converter."""
