"""Physical layer: PFB front end (kernels K2, K3), demod, burst sync."""
