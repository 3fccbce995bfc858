"""Device ops of the port: geometry, hashing, integrate, refine, extract."""
