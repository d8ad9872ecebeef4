"""Device ops of the port: attention kernels and losses."""
