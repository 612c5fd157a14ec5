"""The benchmark's own copies of the input arithmetic: lattices, the Voronoi
polycrystal, the element colours and the preset camera.  Nothing here
imports the program; a configuration's ``scene.kind`` names the module of
this package that builds its atoms (``build(spec, rng)``)."""
