"""File I/O of the port: readers, writers and trajectories."""
