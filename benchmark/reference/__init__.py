"""Plain references of the benchmark's configurations. They import neither
JAX, the JAX package nor the port, and take nothing the port has made."""
