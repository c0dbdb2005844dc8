"""Host utilities: artifact checksums and circuit-shape pinning."""
