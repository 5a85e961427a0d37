"""Utilities of the port: input checks, tensor helpers, enums, the device rule
and the state bridge from the JAX package."""
