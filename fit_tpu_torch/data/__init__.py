"""Host-side latent dataset and batch loader (numpy)."""
