"""The FiT and DiT denoisers, their layers and the flax weight converter."""
