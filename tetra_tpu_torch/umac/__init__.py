"""Upper-MAC control plane (native executor bindings)."""
