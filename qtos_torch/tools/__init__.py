"""Development tools of the port, run by hand on a CUDA card."""
