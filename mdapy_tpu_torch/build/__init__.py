"""Crystal builders: lattices, HEA, orthogonal cells, polycrystals."""
