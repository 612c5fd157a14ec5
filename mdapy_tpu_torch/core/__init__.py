"""Host-side data and cell math the port needs, copied so that it imports
nothing of the JAX package."""
