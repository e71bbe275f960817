"""Host-side math: positional tables, patch geometry, noise schedules."""
