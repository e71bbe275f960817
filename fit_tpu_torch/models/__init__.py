"""The FiT denoiser, its layers and the flax weight converter."""
