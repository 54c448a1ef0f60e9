"""Host-side utilities: the acquisition-geometry plot."""
