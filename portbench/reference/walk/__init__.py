"""The reference's upper MAC, LLC and crypto: frozen copies of the
port's Python control plane (itself a line-for-line copy of the JAX
package's), driven slot by slot by `portbench.reference.walk_ref`."""
