"""Host-side image I/O."""
