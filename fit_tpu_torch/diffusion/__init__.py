"""Gaussian diffusion and its sampling loops."""
