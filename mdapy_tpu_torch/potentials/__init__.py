"""The potentials' force path: EAM, NEP and the FIRE minimizer."""
